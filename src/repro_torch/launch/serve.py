"""Batched serving driver: token-by-token prefill and greedy decode with a
KV cache, the port of ``repro/launch/serve.py``.

``python -m repro_torch.launch.serve --arch <id> [--batch B] [--gen N]
[--device cpu]``

Runs reduced configs (``--reduced`` is on by default, as in the
reference) on the card, or on the CPU with ``--device cpu``.  The decode
step runs as one CUDA graph (:class:`CapturedDecode`) on the card.  MoE
archs print the paper analyzer's dispatch decision
(``moe_dispatch_report``) at startup.
"""
from __future__ import annotations

import argparse
import time


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card; 'cpu' to run "
                         "on the CPU)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.configs.reduced import reduce_config
    from repro_torch.device import resolve_device
    from repro_torch.launch.steps import CapturedDecode
    from repro_torch.models.ffn import moe_dispatch_report
    from repro_torch.models.registry import build_model

    dev = resolve_device(args.device)
    cfg = ARCHS[args.arch]
    if args.reduced:
        cfg = reduce_config(cfg)
    bundle = build_model(cfg)

    if cfg.ffn == "moe":
        rep = moe_dispatch_report(cfg, tokens=args.batch)
        print(f"[serve] MoE dispatch analyzer: density {rep['density']:.3f} "
              f"-> {rep['primitive']} (t_sparse {rep['t_sparse']:.2e}s vs "
              f"t_dense {rep['t_dense']:.2e}s)")

    params = bundle.init(0, dev)
    rng = np.random.default_rng(0)
    max_len = args.prompt_len + args.gen
    prompts = rng.integers(0, cfg.vocab, (args.batch, args.prompt_len))

    decode = CapturedDecode(bundle)
    cache = bundle.init_cache(args.batch, max_len, dev)
    prompt = torch.as_tensor(prompts, device=dev)

    # prefill token by token, as the reference's serve loop
    t0 = time.time()
    logits = None
    for t in range(args.prompt_len):
        logits, cache = decode(params, cache, prompt[:, t:t + 1], t)
    toks = []
    for t in range(args.prompt_len, max_len):
        nxt = torch.argmax(logits, dim=-1)[:, None]
        toks.append(nxt)
        logits, cache = decode(params, cache, nxt, t)
    out = torch.cat(toks, dim=1).cpu().numpy()
    dt = time.time() - t0
    total_toks = args.batch * max_len
    print(f"[serve] {args.arch}: generated {out.shape} in {dt:.2f}s "
          f"({total_toks / dt:.1f} tok/s incl. prefill)")
    print(f"[serve] sample: {out[0][:12].tolist()}")


if __name__ == "__main__":
    main()
