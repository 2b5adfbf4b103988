"""The JAX package's examples (``examples/*.py``) through the port: a
quickstart, a batch of served requests, a ~100M-parameter training run
with checkpoints and a resume check, and the HeteroAuto walkthrough.
Each runs as ``python -m repro_torch.examples.<name>``; each but
``hetero_search`` runs on the card unless ``--device cpu`` is given."""
