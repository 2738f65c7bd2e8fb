"""mmlspark_tpu_torch — the PyTorch/CUDA port of mmlspark_tpu.

A package beside the JAX reference (``mmlspark_tpu``) that runs the same
pipelines on NVIDIA GPUs through PyTorch and hand-written CUDA kernels
(``csrc/``). It imports neither JAX nor the reference. Entry points run on
CUDA unless the caller asks for the CPU (``runtime.use_device("cpu")`` or
``device="cpu"``).

Ported so far: the LightGBM-equivalent GBDT fit -> transform
(``mmlspark_tpu_torch.gbdt``) over the columnar DataFrame
(``mmlspark_tpu_torch.core``), on dense feature vectors and on sparse (CSR)
rows, with fused scoring (``core.fusion``); and transformer-encoder serving
through the ``DNNModel`` stage (``mmlspark_tpu_torch.models``).
"""

__version__ = "0.1.0"
