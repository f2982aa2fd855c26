"""KV-cache serving demo: train the demo LM a few steps (or restore a
checkpoint saved by the trainer, e.g. on a drain), then decode
continuations with the per-layer KV cache.

The port of the JAX package's ``examples/generate.py``, with the same
flags and output lines, and ``--device`` (default ``cuda``).  The weights
move from the training path into decode mode unchanged.

    python -m k8s_operator_libs_tpu_torch.examples.generate --steps 20 --new-tokens 16
    python -m k8s_operator_libs_tpu_torch.examples.generate --restore-dir /ckpts --restore-step 100
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..tpu import workload as wl

#: The demo configuration of the JAX example.
CONFIG = wl.ModelConfig(
    vocab_size=256, d_model=64, n_heads=4, n_layers=2, d_ff=128, max_seq_len=64
)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--steps", type=int, default=10,
        help="quick training steps before decoding (ignored with --restore-dir)",
    )
    parser.add_argument(
        "--restore-dir", default=None,
        help="checkpoint directory (CheckpointingTrainer's) to restore instead of training",
    )
    parser.add_argument("--restore-step", type=int, default=None)
    parser.add_argument("--batch", type=int, default=2)
    parser.add_argument("--prompt-len", type=int, default=8)
    parser.add_argument("--new-tokens", type=int, default=16)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument(
        "--temperature", type=float, default=0.0,
        help="0 = greedy; >0 samples the softmax at this temperature",
    )
    parser.add_argument(
        "--top-k", type=int, default=0,
        help="restrict sampling to the k most-probable tokens (0 = all)",
    )
    parser.add_argument(
        "--int8", action="store_true", help="serve weight-only int8 quantized weights"
    )
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    if args.restore_dir and args.restore_step is None:
        parser.error("--restore-dir needs --restore-step")

    device = wl.resolve_device(args.device)
    model, optimizer = wl.create_train_state(CONFIG, device)
    if args.restore_dir:
        restored = wl.restore_checkpoint(args.restore_dir, args.restore_step, map_location=device)
        model.load_state_dict(restored["model"])
        print(f"restored checkpoint step {restored['step']}")
    else:
        step = wl.make_train_step(model, optimizer)
        loss = None
        for i in range(args.steps):
            loss = step(wl.make_batch(CONFIG, 8, seed=i, device=device))
        if loss is not None:
            print(f"trained {args.steps} steps, loss {float(loss):.4f}")
        else:
            print("trained 0 steps (serving freshly initialized params)")

    rng = np.random.default_rng(args.seed)
    prompt = torch.from_numpy(
        rng.integers(0, CONFIG.vocab_size, (args.batch, args.prompt_len))
    ).to(device)
    served = wl.quantize_model(model) if args.int8 else model

    def run():
        out = wl.generate(
            CONFIG, served, prompt, args.new_tokens, temperature=args.temperature,
            top_k=args.top_k, seed=args.seed, device=device,
        )
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return out

    run()  # warm
    t0 = time.perf_counter()
    out = run()
    elapsed = time.perf_counter() - t0
    for row in out.cpu().numpy():
        head = " ".join(str(t) for t in row[: args.prompt_len])
        tail = " ".join(str(t) for t in row[args.prompt_len:])
        print(f"prompt [{head}] -> [{tail}]")
    rate = args.batch * args.new_tokens / max(elapsed, 1e-9)
    print(
        f"{args.new_tokens} tokens x {args.batch} sequences in "
        f"{elapsed*1e3:.1f} ms ({rate:.0f} tokens/s, KV-cache decode"
        f"{', int8' if args.int8 else ''}"
        f"{f', T={args.temperature} top_k={args.top_k}' if args.temperature > 0 else ', greedy'})"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
