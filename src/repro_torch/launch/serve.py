"""Serving launcher (port of the ``--arch`` mode of ``repro/launch/serve.py``):
batched greedy decode with a KV cache.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch micro-lm --tokens 32

Runs on the card unless ``--device cpu`` is given.  The JAX launcher's
``--green-route`` mode is not ported yet: its simulated horizon runs the
simulator under the chunked serving engine (``core/serving_kernels.py``,
ROADMAP Queue 1 step 2, item 11), which the port does not have.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve
from repro_torch.models.model import build_model


@torch.inference_mode()
def greedy_decode(model, params, prompt_tokens: torch.Tensor, max_new: int, cache_len: int):
    """Feed the prompt one token at a time through ``decode_step`` (as the
    JAX launcher does), then ``max_new`` argmax tokens.  Returns
    (B, P + max_new) tokens on the prompt's device."""
    B, P = prompt_tokens.shape
    cache = model.init_cache(B, cache_len, device=prompt_tokens.device)
    tok = prompt_tokens[:, 0]
    out = [tok]
    for i in range(P + max_new - 1):
        logits, cache = model.decode_step(params, cache, {"token": tok, "index": i})
        nxt = torch.argmax(logits, dim=-1).to(prompt_tokens.dtype)
        tok = prompt_tokens[:, i + 1] if i + 1 < P else nxt
        out.append(tok)
    return torch.stack(out, dim=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="micro-lm")
    ap.add_argument("--smoke", action="store_true", help="the arch's reduced() config")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--tokens", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    model = build_model(cfg)
    params = model.init(args.seed, device=device)
    gen = torch.Generator().manual_seed(args.seed + 1)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len), generator=gen).to(device)
    t0 = time.time()
    seqs = greedy_decode(model, params, prompt, args.tokens, args.prompt_len + args.tokens)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    n_new = args.batch * args.tokens
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"[serve] generated {n_new} tokens in {dt:.2f}s "
          f"({n_new / dt:.1f} tok/s batched) on {where}")
    print("[serve] sample:", seqs[0].tolist())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
