"""Serving driver: batched generation with the prefill/decode engine.

    python -m repro_torch.launch.serve --arch qwen3-1.7b --smoke \
        --batch 4 --prompt-len 32 --max-new 32 [--device cpu]

Runs on the card unless ``--device cpu`` is given. Weights, prompts and
stub frontend inputs (audio frames, vision embeddings) are drawn from
``--seed``. ``generate`` runs twice: the first call's time includes the
kernels' build and the first launches, the second is the steady state;
both are printed with their tokens/s.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import DTYPES, default_device
from repro_torch.configs import get_config
from repro_torch.models import init_params
from repro_torch.serve.engine import generate


def _timed(fn, device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = default_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    gen = torch.Generator(device).manual_seed(args.seed)
    params = init_params(cfg, gen)
    gen.manual_seed(args.seed + 1)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen, device=device)
    cdt = DTYPES[cfg.compute_dtype]
    kw = {}
    if cfg.family == "audio":
        kw["frames"] = torch.randn(
            (args.batch, cfg.encoder_seq, cfg.d_model), generator=gen,
            device=device).mul_(0.1).to(cdt)
    if cfg.family == "vlm":
        kw["vision_embeds"] = torch.randn(
            (args.batch, cfg.n_vision_tokens, cfg.d_model), generator=gen,
            device=device).mul_(0.1).to(cdt)

    n_tok = args.batch * args.max_new
    for call in ("first", "second"):
        sample = torch.Generator(device).manual_seed(args.seed + 2)
        out, dt = _timed(lambda: generate(
            cfg, params, prompts, max_new_tokens=args.max_new,
            temperature=args.temperature, generator=sample, **kw), device)
        print(f"[serve] {cfg.name} on {device.type}: {call} call generated "
              f"{n_tok} tokens in {dt:.3f}s ({n_tok / dt:.1f} tok/s)")
    out = out.cpu()
    for b in range(min(args.batch, 2)):
        print(f"[serve]   seq{b}: {out[b][:16].tolist()} ...")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
