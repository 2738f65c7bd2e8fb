"""Compute ops (the port of ``mmlspark_tpu.ops``): image processing — the
host ops and their batched device mirrors (``ops.image``) —, VW's
murmur3 feature hashing (``ops.hashing``) and LIME's batched ISTA lasso
(``ops.lasso``)."""
