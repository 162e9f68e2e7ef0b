#!/usr/bin/env python3
"""Where the cuda and torch LM programs' logits part, layer by layer, on
one NVIDIA card.

    python3 tools/layer_gap.py [--arch zamba2-7b] [--decode 32]

The model at its published widths and depth, random weights from seed 0
on the card (as ``chip_smoke.py``'s ``lm_serving_phase`` draws them), and
``chip_smoke.py``'s first wave of LM requests (4 prompts of 128-1,024
tokens, left-padded as ``ServingEngine`` pads them). The ``cuda`` model
(the flash kernel in prefill) and the ``torch`` model (its plain version)
prefill the same tokens: each layer's output is recorded in both, and
the largest absolute difference between them, the largest absolute value
and their ratio are printed layer by layer. Then ``--decode`` greedy
steps of both, the cuda program's tokens fed to both: each step's
largest logit difference. Then, at each flash call of the cuda prefill
(its real q, k, v), the kernel's and the plain version's largest and
root-mean-square error against the same function in float64, over the
first and the last 128 query rows apart. Measurement only: the
transformer's ``_apply_layer`` and the flash executor are wrapped for
the calls. Prints the card's name and power limit, then one JSON line.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.ref import flash_attention_ref  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402


def recorded_prefill(model, params, tokens, max_seq: int, device) -> tuple:
    """``model.prefill`` of ``tokens`` with every layer's output kept:
    (last logits, cache, [(kind, output)])."""
    apply_layer = transformer._apply_layer
    outs = []

    def record(p, cfg, kind, *args, **kw):
        x, cache, aux = apply_layer(p, cfg, kind, *args, **kw)
        outs.append((kind, x.detach().clone()))
        return x, cache, aux

    transformer._apply_layer = record
    try:
        cache = model.init_cache(tokens.shape[0], max_seq, dtype=torch.float32,
                                 device=device)
        logits, cache = model.prefill(params, tokens, cache)
    finally:
        transformer._apply_layer = apply_layer
    return logits, cache, outs


def exact_attention(q, k, v) -> torch.Tensor:
    """Causal softmax(q·kᵀ/sqrt(D))·v in float64 (query head h reads KV
    head h // (H / Hkv))."""
    b, h, t, d = q.shape
    hkv = k.shape[1]
    qg = q.double().reshape(b, hkv, h // hkv, t, d)
    logits = torch.einsum("bkgqd,bksd->bkgqs", qg, k.double()) / d ** 0.5
    above = torch.ones((t, k.shape[2]), dtype=torch.bool, device=q.device).triu(1)
    probs = torch.softmax(logits.masked_fill(above, float("-inf")), dim=-1)
    return torch.einsum("bkgqs,bksd->bkgqd", probs, v.double()).reshape(b, h, t, d)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="zamba2-7b")
    ap.add_argument("--decode", type=int, default=32)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("layer_gap: needs an NVIDIA card", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    card = chip_smoke.card_line()
    print(f"[card] {card}")
    sizes = chip_smoke.Sizes()
    cfg = get_config(args.arch)
    model, ref = build_model(cfg, inner="cuda"), build_model(cfg, inner="torch")
    params = model.init(torch.Generator(device=device).manual_seed(0), device=device)
    reqs = chip_smoke.lm_requests(sizes, cfg.vocab_size)[:sizes.lm_slots]
    longest = max(len(r.prompt) for r in reqs)
    toks = np.zeros((len(reqs), longest), np.int32)
    for i, r in enumerate(reqs):
        toks[i, longest - len(r.prompt):] = r.prompt
    tokens = torch.from_numpy(toks).to(device, torch.long)
    max_seq = sizes.lm_prompts[1] + sizes.lm_new_tokens
    with torch.no_grad():
        got, cache, outs = recorded_prefill(model, params, tokens, max_seq, device)
        want, ref_cache, ref_outs = recorded_prefill(ref, params, tokens, max_seq, device)
        layers = []
        for i, ((kind, a), (_, b)) in enumerate(zip(outs, ref_outs)):
            diff, top = float((a - b).abs().max()), float(b.abs().max())
            layers.append({"layer": i, "kind": kind, "max_abs_diff": diff,
                           "max_abs": top, "rel": diff / top})
            print(f"[gap] layer {i:2d} {kind:11s} |diff| {diff:.3e} |x| {top:.3e} "
                  f"rel {diff / top:.3e}")
        steps = [float((got - want).abs().max())]
        for _ in range(args.decode):
            cur = got.argmax(-1)[:, None]
            got, cache = model.decode_step(params, cache, cur)
            want, ref_cache = ref.decode_step(params, ref_cache, cur)
            steps.append(float((got - want).abs().max()))
    print(f"[gap] prefill then {args.decode} decode steps: largest logit difference "
          + ", ".join(f"{d:.3e}" for d in steps))
    del cache, ref_cache, outs, ref_outs
    flash_err = []
    for i, (q, k, v) in enumerate(chip_smoke.capture_flash(model, params, tokens, max_seq,
                                                           device)):
        exact = exact_attention(q, k, v)
        row = {"site": i}
        for name, out in (("kernel", flash_attention(q, k, v, causal=True)),
                          ("plain", flash_attention_ref(q, k, v, causal=True))):
            err = (out.double() - exact).abs()
            row[name] = {"max": float(err.max()), "rms": float(err.pow(2).mean().sqrt()),
                         "first_128_max": float(err[:, :, :128].max()),
                         "last_128_max": float(err[:, :, -128:].max())}
        row["max_abs_out"] = float(exact.abs().max())
        flash_err.append(row)
        print(f"[gap] flash site {i}: " + json.dumps(row))
    print(card)
    print(json.dumps({"arch": cfg.name, "tokens": list(tokens.shape), "layers": layers,
                      "logit_diff_by_step": steps, "flash_err": flash_err,
                      "max_abs_logit": float(want.abs().max())}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
