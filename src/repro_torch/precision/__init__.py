"""Precision alignment (DiTorch §3.1.2, Fig. 5, Table 1): the port's copy
of ``repro/precision``.

``backends`` holds the numerics regimes ("chips") and the six operator
probes; ``align`` runs the two stages of the harness, the operator sweep
and the loss-curve MRE of a model trained under each regime, on the card
unless the caller passes ``device="cpu"``.
"""
