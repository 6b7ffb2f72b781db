"""Train a ~100M-param LM (qwen3-shaped) for a few hundred steps on the
port (counterpart of ``examples/train_lm.py``, on ``repro_torch``). Thin
wrapper over the fault-tolerant launcher (checkpoints, auto-resume,
straggler logging); the checkpoints and metrics go under the temporary
directory (``tempfile.gettempdir()``), so a rerun resumes:

  PYTHONPATH=src python examples/torch_train_lm.py [--steps 200] \
      [--device cuda]
"""
import argparse
import os
import sys
import tempfile

from repro_torch.launch.train import main as train_main


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    out = os.path.join(tempfile.gettempdir(), "repro_torch_train_lm")
    sys.exit(train_main([
        "--arch", args.arch, "--scale", "tiny",
        "--steps", str(args.steps), "--batch", "8", "--seq", "256",
        "--ckpt-dir", out,
        "--metrics-out", os.path.join(out, "metrics.jsonl"),
        "--device", args.device,
    ]))
