"""Train an LM with the PyTorch/CUDA port's full substrate: the train step,
the synthetic data pipeline with prefetch, periodic checkpoints and
crash-resume (the counterpart of examples/train_lm.py, with its flags).

    PYTHONPATH=src python examples/train_lm_torch.py [--steps 200] \\
        [--device cpu]

The default config is qwen2's smoke config; ``--arch`` accepts any
architecture whose attention and mixers have a backward on the card
(mamba2-130m trains on the CPU only until its SSD-scan backward exists);
``--full`` uses the published config (qwen2-0.5b at full width fits one
H100). ``--device`` is ``cuda`` unless the CPU is asked for.
"""
import argparse
import sys

sys.path.insert(0, "src")

from repro_torch.launch.train import train


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt", default="/tmp/repro_torch_train_ckpt")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    losses = train(args.arch, steps=args.steps, batch=args.batch,
                   seq=args.seq, smoke=not args.full, ckpt_dir=args.ckpt,
                   ckpt_every=50, device=args.device)
    print(f"[train_lm] loss {losses[0]:.3f} -> {losses[-1]:.3f} over "
          f"{len(losses)} steps (checkpoints in {args.ckpt})")


if __name__ == "__main__":
    main()
