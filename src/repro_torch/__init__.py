"""PyTorch / CUDA port of ``repro`` for NVIDIA Hopper (H100).

Mirrors ``repro``'s module names so each counterpart sits at the same
path (``repro_torch.models.attention`` ↔ ``repro.models.attention``).
Imports ``torch`` and numpy only — never ``jax`` and nothing of
``repro``.  Parameters are nested dicts of tensors with the JAX names
and layouts (stacked ``(L, …)`` leaves, ``x @ W`` matrices), so weights
carry across with ``repro_torch.bridge`` by type conversion alone.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(see ``repro_torch.device``).  The TPU Pallas kernels on the serving
path are hand-written CUDA kernels under ``kernels/csrc``.
"""
