"""End-to-end training on the PyTorch/CUDA port: a small LM for a few
hundred steps with checkpoints, deterministic restartable data and AdamW,
through the port's launcher (``repro_torch.launch.train``; no JAX).

Presets:
  tiny  — 1.6M params, seconds on the card or a CPU
  100m  — GPT-2-small-scale decoder (~110M params)

  PYTHONPATH=src python examples/train_lm_torch.py --preset tiny --steps 60
  PYTHONPATH=src python examples/train_lm_torch.py --device cpu --steps 20

Prints the preset's parameter count, a ``[train]`` line every 10 steps
(loss, learning rate, gradient norm), the launcher's final JSON line and
the final loss. Checkpoints go to ``build/train_lm_torch/`` (every 25
steps); re-running with more ``--steps`` resumes from the newest one.
"""
import argparse
import sys
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import repro_torch.configs as configs  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402

PRESETS = {
    "tiny": ModelConfig(
        name="tiny-lm", family="dense", n_layers=4, d_model=128,
        n_heads=4, n_kv_heads=4, d_ff=512, vocab_size=2048),
    "100m": ModelConfig(
        name="lm-100m", family="dense", n_layers=12, d_model=768,
        n_heads=12, n_kv_heads=12, d_ff=3072, vocab_size=32768),
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=list(PRESETS), default="tiny")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=str(ROOT / "build"
                                              / "train_lm_torch"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA)")
    args = ap.parse_args()

    cfg = PRESETS[args.preset]
    print(f"[train_lm_torch] {cfg.name}: {cfg.param_count()/1e6:.1f}M "
          f"params")

    # register the preset so the generic launcher can find it
    mod = types.ModuleType("preset")
    mod.full = lambda: cfg
    mod.smoke = lambda: cfg
    sys.modules["repro_torch.configs._preset"] = mod
    configs.ALIASES["_preset"] = "_preset"

    argv = ["--arch", "_preset", "--steps", str(args.steps),
            "--batch", str(args.batch), "--seq", str(args.seq),
            "--ckpt-dir", args.ckpt_dir, "--ckpt-every", "25",
            "--log-every", "10"]
    if args.device:
        argv += ["--device", args.device]
    loss = train_launcher.main(argv)
    print(f"[train_lm_torch] done, final loss {loss:.4f} "
          f"(resume by re-running with more --steps)")


if __name__ == "__main__":
    main()
