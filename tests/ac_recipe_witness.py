"""The audio_cues recipe against the JAX package's, on the CPU: both
pipelines' ``main`` train ``middle_fusion_mobile`` with ac_config's recipe
(batch 32, lr 1e-3, the 2-epoch warmup, plateau min/0.5/3, a test every
epoch) for 3 epochs on the same synthetic corpus that ``chip_smoke.py``'s
[ac-train] builds (4 words x 68 aligned wav + cue clips per split), and
print both histories. Each trained model is then evaluated on the
validation split twice: with the running BatchNorm statistics that
training left, and with statistics re-estimated over the training split
with the weights frozen (the mean of every training batch's statistics,
train-mode forward).

Not a test (about 3 minutes on the CPU); run it from the repository root::

    python tests/ac_recipe_witness.py [--seed 0] [--clips-per-split 68]
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

WORDS = ("abend", "bereits", "cirka", "dabei")
KEYS = ("train_loss", "train_acc", "val_loss", "val_acc", "test_loss", "test_acc", "lr")


def ac_dict(root: str, base: str, seed: int) -> dict:
    return {
        "dataset": {"root_dir": root, "cue_root": root, "input_size": 117, "cue_mode": "emotion",
                    "embed_model": "mpnet", "cache_dir": os.path.join(base, "cache"), "num_classes": len(WORDS)},
        "model": {"name": "middle_fusion_mobile", "dtype": "float32"},
        "train": {"batch": 32, "lr": 1e-3, "epochs": 3, "seed": seed},
        "output": {"base_dir": base, "plots": False},
    }


def capture_trainer(trainer_cls) -> list:
    """Patch ``trainer_cls.fit`` to keep the trainer that ran it."""
    seen, fit = [], trainer_cls.fit

    def keeping(self, *args, **kwargs):
        seen.append(self)
        return fit(self, *args, **kwargs)

    trainer_cls.fit = keeping
    return seen


def train_batches(ds, batch: int):
    for i in range(0, len(ds.labels) - batch + 1, batch):
        yield tuple(x[i : i + batch] for x in ds.inputs)


def port_precise_bn(trainer, train_ds, batch: int):
    """The port's model with every BatchNorm's running statistics replaced
    by the mean of its train-mode batch statistics over ``train_ds``."""
    import torch

    from multimodal_lipread_torch.nn.common import BatchNorm

    model = trainer.model
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    sums = [[torch.zeros_like(b.running_mean), torch.zeros_like(b.running_var)] for b in bns]
    model.train()
    n = 0
    with torch.no_grad():
        for xs in train_batches(train_ds, batch):
            for b in bns:
                b.momentum = 0.0
            model(*(trainer._prepare(torch.from_numpy(x).to(trainer.device)) for x in xs))
            for s, b in zip(sums, bns):
                s[0] += b.running_mean
                s[1] += b.running_var
            n += 1
        for s, b in zip(sums, bns):
            b.running_mean.copy_(s[0] / n)
            b.running_var.copy_(s[1] / n)
    model.eval()


def jax_precise_bn(trainer, train_ds, batch: int) -> dict:
    """The JAX trainer's batch statistics re-estimated the same way (Flax's
    momentum 0.9 undone: ``batch = (new - 0.9 old) / 0.1``)."""
    import jax
    import jax.numpy as jnp

    params, stats = trainer.state["params"], trainer.state["batch_stats"]
    total, n = jax.tree_util.tree_map(jnp.zeros_like, stats), 0
    for xs in train_batches(train_ds, batch):
        _, upd = trainer.model.apply({"params": params, "batch_stats": stats}, *(jnp.asarray(x) for x in xs),
                                     train=True, mutable=["batch_stats"],
                                     rngs={"dropout": jax.random.PRNGKey(n)})
        total = jax.tree_util.tree_map(lambda t, new, old: t + (new - 0.9 * old) / 0.1, total,
                                       upd["batch_stats"], stats)
        n += 1
    return jax.tree_util.tree_map(lambda t: t / n, total)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--clips-per-split", type=int, default=68)
    args = parser.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    from multimodal_lipread_tpu.config import Config as JConfig
    from multimodal_lipread_tpu.pipelines import audio_cues as jac_pipeline
    from multimodal_lipread_tpu.train.trainer import Trainer as JTrainer

    from multimodal_lipread_torch.config import Config
    from multimodal_lipread_torch.data.synthetic import make_synthetic_glips
    from multimodal_lipread_torch.pipelines import audio_cues as pac_pipeline
    from multimodal_lipread_torch.train.trainer import Trainer

    tmp = tempfile.mkdtemp(prefix="ac_recipe_witness_")
    os.environ["HF_HUB_CACHE"] = os.path.join(tmp, "hf_hub")  # both packages take the hashing embedder
    root = make_synthetic_glips(os.path.join(tmp, "GLips_4"), words=WORDS, clips_per_split=args.clips_per_split,
                                seed=args.seed, with_cues=True)
    jseen, pseen = capture_trainer(JTrainer), capture_trainer(Trainer)
    runs = {"jax": jac_pipeline.main(JConfig.from_dict(ac_dict(root, os.path.join(tmp, "jax"), args.seed))),
            "port": pac_pipeline.main(Config.from_dict(ac_dict(root, os.path.join(tmp, "port"), args.seed)),
                                      device="cpu")}
    for name, result in runs.items():
        for h in result["history"]:
            print(f"{name} epoch {h['epoch']}: " + " ".join(f"{k} {h[k]:.4f}" for k in KEYS))

    jds, _ = jac_pipeline.load_audio_cue_datasets(root, root, input_size=117)
    pds, _ = pac_pipeline.load_audio_cue_datasets(root, root, input_size=117, device="cpu")
    (jt,), (pt,) = jseen, pseen
    # after fit, both trainers hold the last epoch's weights and statistics
    before = {"jax": jt.evaluate(jds["val"]), "port": pt.evaluate(pds["val"])}
    port_precise_bn(pt, pds["train"], 32)
    after = {"jax": jt.evaluate(jds["val"], batch_stats=jax_precise_bn(jt, jds["train"], 32)),
             "port": pt.evaluate(pds["val"])}
    for name in runs:
        print(f"{name} last epoch on val: running statistics from training loss {before[name].loss:.4f} acc "
              f"{before[name].acc:.2f}%; re-estimated over the training split loss {after[name].loss:.4f} acc "
              f"{after[name].acc:.2f}%")
    return 0


if __name__ == "__main__":
    sys.exit(main())
