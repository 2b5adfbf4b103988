"""Tensor-parallel placement of a HeteroPP stage's block parameters
(``TP_COLUMN_PARAMS``, ``TP_ROW_PARAMS``, ``tp_body_dim``,
``tp_local_slice``): one copy of them lives in ``sharding/rules.py``, the
torch copy of the JAX package's rules; this module re-exports it for the
pipeline runtime."""
from __future__ import annotations

from ..sharding.rules import (TP_COLUMN_PARAMS, TP_ROW_PARAMS,  # noqa: F401
                              tp_body_dim, tp_local_slice)
