"""multimodal_lipread_torch — the PyTorch/CUDA port of ``multimodal_lipread_tpu``.

Module paths mirror the JAX package so each counterpart is easy to find.
The port imports ``torch`` and never JAX or the JAX package. Its entry
points run on a CUDA card unless the caller passes ``device="cpu"``; its
one hand-written kernel, the log-mel frontend (``ops/logmel_cuda.py`` +
``csrc/logmel.cu``), is built with plain ``nvcc`` at first use.

Ported so far, trained (``pipelines/``, ``train/trainer.py``) and served
(``serving.py``): the audio ``vgg_lstm`` pipeline (WAV clips → threaded
native decode → log-mel on the device → VGG16-BN → 2-layer BiLSTM →
classifier) and the video-only pipeline with the reference's seven models
(uint8 lip tensors → frame backbone over every frame → BiLSTM, attention,
Transformer or temporal convolutions → classifier). See ROADMAP.md for
what remains.
"""

__version__ = "0.1.0"

from multimodal_lipread_torch.config import Config, load_config  # noqa: F401
