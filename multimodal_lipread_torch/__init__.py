"""multimodal_lipread_torch — the PyTorch/CUDA port of ``multimodal_lipread_tpu``.

Module paths mirror the JAX package so each counterpart is easy to find.
The port imports ``torch`` and never JAX or the JAX package. Its entry
points run on a CUDA card unless the caller passes ``device="cpu"``; its
hand-written kernels, the log-mel frontend (``ops/logmel_cuda.py`` +
``csrc/logmel.cu``) and the lip crop (``ops/crop_resize_cuda.py`` +
``csrc/crop_resize.cu``), are built with plain ``nvcc`` at first use.

Ported so far, trained (``pipelines/``, ``train/trainer.py``) and served
(``serving.py``): the audio pipeline with its eight models (WAV clips →
threaded native decode → log-mel on the device → e.g. VGG16-BN → 2-layer
BiLSTM → classifier), the video-only pipeline with its eight models (uint8
lip tensors → frame backbone over every frame → BiLSTM, attention,
Transformer, conformer or temporal convolutions → classifier), and the
audio_video fusion pipeline with the reference's seven models (both
halves, joined clip by clip), the cue classifiers and the audio_cues,
cues_video and audio_cues_video fusions; ``model.pretrained`` grafts
converted backbone weights into any of them. Training also streams
(``data/grain_loader.py``: WAV clips, ``.npy`` lips, or ``.mp4`` clips
cropped on the host or by the crop kernel in the train step; with
``dataset.loader_backend: native`` through the C++ prefetcher and an int16
wire) and runs device-resident steps as CUDA graphs. Audio decodes through
ffmpeg where a clip is not 16 kHz WAV (``tools/transcode.py`` builds a WAV
mirror once). Serving also measures tail latency (``load_test``) and
exports a checkpoint's graph with ``torch.export``; ``cli.py`` holds the
entry functions and ``data/frame_extraction.py``, ``tools/data_clean.py``
the offline tools. Several GPUs (``parallel/``): every pipeline trains
data-parallel under ``torch.distributed.run`` (DDP over NCCL), the BERT cue
model also tensor- and pipeline-parallel, and serving runs a replica per
card (``--data-parallel``). See ROADMAP.md for what remains.
"""

__version__ = "0.1.0"

from multimodal_lipread_torch.config import Config, load_config  # noqa: F401
