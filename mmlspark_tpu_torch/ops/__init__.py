"""Compute ops (the port of ``mmlspark_tpu.ops``): image processing — the
host ops and their batched device mirrors (``ops.image``). Hashing and
``lasso`` wait for ROADMAP A steps 8 and 10."""
