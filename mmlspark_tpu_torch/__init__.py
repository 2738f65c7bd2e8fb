"""mmlspark_tpu_torch — the PyTorch/CUDA port of mmlspark_tpu.

A package beside the JAX reference (``mmlspark_tpu``) that runs the same
pipelines on NVIDIA GPUs through PyTorch and hand-written CUDA kernels
(``csrc/``). It imports neither JAX nor the reference. Entry points run on
CUDA unless the caller asks for the CPU (``runtime.use_device("cpu")`` or
``device="cpu"``).

Ported so far: the LightGBM-equivalent GBDT fit -> transform
(``mmlspark_tpu_torch.gbdt``) over the columnar DataFrame
(``mmlspark_tpu_torch.core``), on dense feature vectors and on sparse (CSR)
rows, with fused scoring (``core.fusion``); transformer-encoder scoring
and training through the ``DNNModel`` stage and ``models.training``
(``mmlspark_tpu_torch.models``), with the switch-MoE FFN; the image path:
ResNet (and torchvision checkpoints) through ``ImageFeaturizer`` and the
image stages (``mmlspark_tpu_torch.image``, ``ops.image``,
``io.image.read_images``); ONNX import and export (``mmlspark_tpu_torch.onnx``:
an imported graph runs as a ``GraphModule``, with a multi-input
``feedDict``); the VW online learner (``mmlspark_tpu_torch.vw``: hashing,
featurizer, the native pass and ``vw_scan`` on the card, stages); serving
of any fitted pipeline over HTTP (``mmlspark_tpu_torch.serving``, with the
frame wire in ``mmlspark_tpu_torch.io`` and metrics, traces and SLOs in
``mmlspark_tpu_torch.obs``); and the featurization, utility and train
layers: ``mmlspark_tpu_torch.featurize`` (TextFeaturizer's hashed sparse
rows, the assemblers, indexers and cleaners, Word2Vec trained on the card),
``mmlspark_tpu_torch.stages`` (column and row plumbing, minibatching, text
preprocessing) and ``mmlspark_tpu_torch.train`` (TrainClassifier,
TrainRegressor and the model statistics), over ``core.utils``.
"""

__version__ = "0.1.0"
