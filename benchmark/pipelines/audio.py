"""The audio pipeline (``pipelines/audio.py``), streaming: raw waveforms
through the native prefetcher and an int16 wire into a model wrapped in
``WaveToLogMel``, so the log-mel kernel runs inside every step and every
served batch."""

from __future__ import annotations

import numpy as np
import torch

from benchmark import data, tracing
from benchmark.reference.layers import read_wav

# WaveToLogMel nests the model's parameters one level deeper
PREFIX = "model."


def optimizer(cfg: dict) -> tuple:
    """(lr, weight decay) of the pipeline's Adam."""
    return cfg["training"]["learning_rate"], cfg["training"]["weight_decay"]


def make_corpus(ctx, n: int) -> data.Corpus:
    return data.make_corpus(ctx.workdir, n, ctx.seed, ctx.device)


def build_train(ctx, corpus: data.Corpus):
    """The trainer and the train split's ``NativeStreamingDataset`` as
    ``pipelines.audio.main`` builds them (``native_streaming_datasets``
    takes every split; the benchmark trains on one)."""
    from multimodal_lipread_torch.data.audio_io import TARGET_SAMPLES
    from multimodal_lipread_torch.data.glips import AUDIO_EXTS, scan_glips
    from multimodal_lipread_torch.data.grain_loader import NativeStreamingDataset
    from multimodal_lipread_torch.models.audio import get_audio_model
    from multimodal_lipread_torch.models.frontend import WaveToLogMel
    from multimodal_lipread_torch.pipelines.common import model_dtype, trainer_extras
    from multimodal_lipread_torch.train.trainer import Trainer, TrainerConfig

    cfg = ctx.program_config
    index = scan_glips(corpus.audio_root, exts=AUDIO_EXTS)
    dataset = NativeStreamingDataset(
        index.by_split("train"), index.class_to_idx, kind="wav", record_shape=(TARGET_SAMPLES,),
        seed=cfg.get("training.seed"), n_threads=cfg.get("dataset.num_workers") or None,
        wire_dtype=cfg.get("dataset.wire_dtype"))
    input_size = cfg.get("dataset.input_size")
    with torch.device(ctx.device):
        model = get_audio_model(cfg.get("model.name"), cfg.get("dataset.num_classes"), input_size=input_size,
                                version=cfg.get("model.version"), use_batchnorm=cfg.get("model.use_batchnorm", True),
                                dtype=model_dtype(cfg))
        model = WaveToLogMel(model, input_size=input_size)
    trainer = Trainer(model, TrainerConfig(
        model_name=cfg.get("model.name"), num_classes=cfg.get("dataset.num_classes"),
        class_names=tuple(index.classes), batch_size=cfg.get("training.batch_size"),
        epochs=cfg.get("training.epochs"), learning_rate=cfg.get("training.learning_rate"),
        weight_decay=cfg.get("training.weight_decay"), scheduler_mode="min", scheduler_factor=0.5,
        scheduler_patience=5, seed=cfg.get("training.seed"), metrics_dir=ctx.path("metrics"),
        checkpoints_dir=ctx.path("models_trained"), test_every_epoch=True,
        rolling_checkpoint=cfg.get("training.rolling_checkpoint", False), **trainer_extras(cfg)),
        device=str(ctx.device))
    return trainer, dataset


def batch_clips(corpus: data.Corpus, inputs: tuple) -> np.ndarray:
    """The clip of each row of a train batch, by its int16 waveform."""
    return corpus.identify(inputs[0].cpu().numpy().astype(np.int16), "waves")


def reference_inputs(corpus: data.Corpus, ids, device) -> tuple:
    """The clips as the reference reads them from their files."""
    return (torch.from_numpy(np.stack([read_wav(corpus.wav_paths[i]) for i in ids])).to(device),)


def build_serve(ctx, corpus: data.Corpus, batch_size: int):
    """A resident ``Predictor`` around the model ``serving`` builds for a
    streaming audio checkpoint, and the request: the files decoded on the
    host (``decode_waveforms``), then the predictor."""
    from multimodal_lipread_torch import serving
    from multimodal_lipread_torch.pipelines.common import decode_waveforms

    with torch.device("meta"):
        model = serving.build_audio_model(ctx.program_config)
    model.load_state_dict({PREFIX + n: t.clone() for n, t in ctx.weights.items()}, strict=True, assign=True)
    predictor = serving.Predictor(model=model, batch_size=batch_size, device=str(ctx.device))

    def request(ids) -> np.ndarray:
        with tracing.span("bench.serve.decode"):
            waves = decode_waveforms([corpus.wav_paths[i] for i in ids])
        with tracing.span("bench.serve.predict", predictor.batch_size):  # padded to its fixed batch
            return predictor.predict_logits(waves)

    return predictor, request
