"""Sharding: the copied rules (``rules``), the logical-axis context
(``ctx``) and the sharded train step over a (data, model) rank grid
(``spmd``)."""
