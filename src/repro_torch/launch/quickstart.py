"""Quickstart: build a tiny model, prefill a prompt, decode a few tokens.

  PYTHONPATH=src python -m repro_torch.launch.quickstart [--arch qwen2-0.5b] [--device cpu]

The port's twin of ``examples/quickstart.py``, through the public API
only: configs registry -> ``tiny_config`` -> ``Model`` -> ``prefill`` ->
grow the cache -> ``decode_step``, with the BPE tokenizer.  Any of the
ten architectures: the attention-only ones, the moe ones, whisper-small
(zero frames for its encoder, as the reference's quickstart gives it),
falcon-mamba-7b (Mamba-1) and zamba2-1.2b (Mamba-2 with a shared
attention block).  It runs on the card
(``--device cuda``, the default, which raises without one) through the
port's kernels, or on the CPU through their plain versions.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.launch.train import tiny_config
from repro_torch.models import model as M
from repro_torch.tokenizer.bpe import default_tokenizer


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the quickstart runs on the card by "
                         "default; pass --device cpu to run on the CPU")
    device = torch.device(args.device)

    tok = default_tokenizer()
    cfg = tiny_config(get_config(args.arch), vocab=tok.vocab_size)
    model = M.Model(cfg, generator=torch.Generator(device).manual_seed(0),
                    device=device)

    prompt = "the quick brown fox"
    ids = tok.encode(prompt, add_bos=True)
    print(f"arch={cfg.name} device={device} prompt={prompt!r} -> "
          f"{len(ids)} tokens")

    total = len(ids) + args.new_tokens
    toks = torch.tensor([ids], dtype=torch.int32, device=device)
    extras = {}
    if cfg.family == "vlm":
        extras["mrope_positions"] = torch.arange(
            toks.shape[1], device=device).expand(3, 1, toks.shape[1])
    if cfg.family == "audio":
        extras["frames"] = torch.zeros(
            (1, cfg.encdec.n_encoder_ctx, cfg.d_model),
            dtype=cfg.param_dtype(), device=device)

    logits, cache = model.prefill(toks, extras)
    # grow the prefill cache to hold the new tokens
    cache = M.grow_cache(cache, cfg, 1, total)
    out = list(ids)
    for _ in range(args.new_tokens):
        nxt = int(logits[0, -1, :tok.vocab_size].argmax())
        out.append(nxt)
        step_extras = {}
        if cfg.family == "vlm":
            step_extras["mrope_positions"] = torch.full(
                (3, 1, 1), len(out) - 1, device=device)
        logits, cache = model.decode_step(
            torch.tensor([[nxt]], dtype=torch.int32, device=device),
            cache, len(out) - 1, step_extras)

    print("generated ids:", out[len(ids):])
    print("decoded text :", repr(tok.decode(out)))
    print("ok")


if __name__ == "__main__":
    main()
