#!/usr/bin/env python3
"""How far a decode step on a ``model`` axis drifts from one device's, by
depth, mesh and dtype: the port's ``make_serve_step(bundle, mesh)`` on
meshes whose coordinates share one card, fed one device's greedy tokens
(teacher forcing), against ``bundle.decode_step`` on one device.

For qwen2.5-3b at its published width with 2, 8 and 36 layers in
bfloat16, and with 36 in float32, on (data 1, model 4), (data 2, model 2)
and, as the control that reassociates no sum, (data 2, model 1) and
(data 4, model 1): each step's largest logit difference, the share of
logits that differ and the greedy agreement, one JSON line a run.  A
model axis reassociates sums (the split-KV combine, the row-parallel
partial products, another GEMM kernel for a column slice); the control
meshes only split the batch's rows.

Run on the card from the root of a checkout::

    python3 scripts/tp_decode_drift.py [--out chiprun_out/drift.jsonl]

``--device cpu`` runs the same at the reduced config (no card needed).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
RUNS = ((2, "bfloat16"), (8, "bfloat16"), (36, "bfloat16"), (36, "float32"))
MESHES = ((1, 4), (2, 2), (2, 1), (4, 1))
BATCH, PROMPT, GEN = 4, 16, 16


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from repro_torch.configs import ARCHS
    from repro_torch.configs.reduced import reduce_config
    from repro_torch.distributed import sharding
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models.registry import build_model

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("tp_decode_drift: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = ARCHS["qwen2.5-3b"]
    if dev.type == "cpu":
        base = reduce_config(base)
    lines = []
    for layers, dtype in RUNS:
        cfg = dataclasses.replace(base, dtype=dtype,
                                  n_layers=min(layers, base.n_layers))
        bundle = build_model(cfg)
        model = bundle.init(0, dev)
        prompts = torch.as_tensor(np.random.default_rng(0).integers(
            0, cfg.vocab, (BATCH, PROMPT)), device=dev)
        cache = bundle.init_cache(BATCH, PROMPT + GEN, dev)
        single, toks = [], []
        logits = None
        for t in range(PROMPT + GEN):
            tok = (prompts[:, t:t + 1] if t < PROMPT
                   else logits.argmax(-1)[:, None])
            if t >= PROMPT:
                toks.append(tok)
            logits, cache = bundle.decode_step(model, cache, tok, t)
            single.append(logits)
        tokens = torch.cat([prompts] + toks, dim=1)
        for shape in MESHES:
            mesh = Mesh.on(dev, shape, ("data", "model"))
            specs = sharding.params_shardings(model, mesh)
            params = {n: sharding.shard(p, specs[n], mesh)
                      for n, p in model.named_parameters()}
            step = make_serve_step(bundle, mesh)
            placed = sharding.shard_cache(bundle.init_cache(
                BATCH, PROMPT + GEN, dev), mesh)
            errs, shares, agree = [], [], []
            for t in range(tokens.shape[1]):
                got, placed = step(params, placed, {
                    "tokens": tokens[:, t:t + 1], "pos": t})
                errs.append((got.float() - single[t].float()).abs().max()
                            .item())
                shares.append((got != single[t]).float().mean().item())
                agree.append(bool(torch.equal(got.argmax(-1),
                                              single[t].argmax(-1))))
            rec = dict(arch=cfg.name, layers=cfg.n_layers, dtype=dtype,
                       mesh=shape, device=(torch.cuda.get_device_name(0)
                                           if dev.type == "cuda" else "cpu"),
                       max_abs_err=max(errs), first_step_err=errs[0],
                       last_step_err=errs[-1],
                       share_differing=float(np.mean(shares)),
                       greedy_agree=float(np.mean(agree)),
                       max_abs_logit=max(x.float().abs().max().item()
                                         for x in single))
            print(json.dumps(rec), flush=True)
            lines.append(rec)
            del params, step, placed
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        del model, cache
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(json.dumps(r) + "\n"
                                          for r in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
