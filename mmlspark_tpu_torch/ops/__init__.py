"""Compute ops (the port of ``mmlspark_tpu.ops``): image processing — the
host ops and their batched device mirrors (``ops.image``) — and VW's
murmur3 feature hashing (``ops.hashing``). ``lasso`` waits for ROADMAP A
step 10."""
