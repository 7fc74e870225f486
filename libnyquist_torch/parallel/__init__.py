"""Multi-card decode: the (dp, sp, tp) mesh of ranks over
``torch.distributed`` and its halo and sum helpers (``mesh.py``)."""
