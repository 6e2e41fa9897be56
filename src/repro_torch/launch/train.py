"""Training CLI: real steps on the card (or the CPU), any arch, resumable.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \\
      --steps 50 --batch 8 --seq 128 --scale tiny --ckpt /tmp/ckpt \\
      --resume auto [--device cpu]

The port's twin of ``repro.launch.train``, with its flags and its
``[train]`` lines: ``--scale tiny`` shrinks the config to a CPU-runnable
size of the same family (``tiny_config``), ``--scale full`` trains the
published config.  Weights come from a ``torch.Generator`` seeded 0 on the
device; batches from the host data pipeline (``train.data``); each step is
``train.step.make_train_step`` (AdamW with a float32 master, the kernels'
backward passes on the card).  Fault tolerance: atomic checkpoints +
``--resume auto`` + the pipeline's straggler skips.  It runs on the card
(``--device cuda``, the default, which fails without one) or, when asked,
on the CPU through the kernels' plain versions.  At the end it prints how
many times this process launched B3 and B4, forward and backward.

Whisper's encoder takes frames and qwen2-vl's M-RoPE takes positions,
which the text pipeline does not make: this CLI gives them the
quickstart's stand-ins, zero frames (the conv frontend is a stub) and the
text positions on all three M-RoPE streams.
"""
from __future__ import annotations

import argparse
import math
import time

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import (
    EncDecConfig,
    ModelConfig,
    MoEConfig,
    SSMConfig,
)
from repro_torch.kernels.flash_attention import (
    flash_attention_bhsd,
    flash_attention_bwd,
)
from repro_torch.kernels.mamba_scan import mamba1_scan, mamba1_scan_bwd
from repro_torch.models import model as M
from repro_torch.train import checkpoint as ckpt_mod
from repro_torch.train import optim
from repro_torch.train.data import DataConfig, DataPipeline
from repro_torch.train.step import make_train_step


def tiny_config(cfg: ModelConfig, vocab: int = 512) -> ModelConfig:
    """A CPU-sized config of ``cfg``'s family (the copy of
    ``repro.launch.train.tiny_config``, same numbers)."""
    over = dict(
        n_layers=max(2, (sum(cfg.local_global_ratio)
                         if cfg.local_global_ratio else 2)),
        d_model=128, d_ff=256 if cfg.d_ff else 0,
        vocab_size=vocab, vocab_pad_multiple=8, dtype="float32",
    )
    if cfg.n_heads:
        over.update(n_heads=4, n_kv_heads=min(cfg.n_kv_heads, 4) or 1,
                    d_head=32)
    if cfg.mrope_sections is not None:
        over["mrope_sections"] = (4, 6, 6)
    if cfg.moe is not None:
        # the port-only fields keep the family's gates and shared experts
        over["moe"] = MoEConfig(n_experts=8, top_k=2, d_ff_expert=64,
                                n_shared_experts=cfg.moe.n_shared_experts and 2,
                                renormalize=cfg.moe.renormalize,
                                shared_gated=cfg.moe.shared_gated)
    if cfg.ssm is not None:
        over["ssm"] = SSMConfig(version=cfg.ssm.version, d_state=8,
                                d_conv=4, expand=2, head_dim=32, dt_rank=8)
    if cfg.encdec is not None:
        over["encdec"] = EncDecConfig(n_encoder_layers=2, n_encoder_ctx=16)
    if cfg.hybrid_period is not None:
        over.update(n_layers=5, hybrid_period=3)
    if cfg.sliding_window is not None:
        over["sliding_window"] = 32
    return cfg.scaled(**over)


def modality_extras(cfg: ModelConfig, batch: int, seq: int, device) -> dict:
    """Zero frames [batch, T, d] for whisper's encoder, the text positions
    [3, batch, seq] for qwen2-vl's M-RoPE; nothing for the other
    families."""
    if cfg.family == "audio" and cfg.encdec is not None:
        return {"frames": torch.zeros(
            (batch, cfg.encdec.n_encoder_ctx, cfg.d_model),
            dtype=cfg.param_dtype(), device=device)}
    if cfg.family == "vlm":
        return {"mrope_positions": torch.arange(
            seq, device=device).expand(3, batch, seq)}
    return {}


def kernel_launches() -> dict:
    """This process's launches of B3 and B4, forward and backward, and of
    B3's backward on its tensor-core route."""
    return {"flash_fwd": flash_attention_bhsd.launches,
            "flash_bwd": flash_attention_bwd.launches,
            "scan_fwd": mamba1_scan.launches,
            "scan_bwd": mamba1_scan_bwd.launches,
            "flash_bwd_wgmma": flash_attention_bwd.launches_by_route["wgmma"]}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--scale", choices=("tiny", "full"), default="tiny")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", choices=("auto", "none"), default="none")
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: training runs on the card by "
                         "default; pass --device cpu to run on the CPU")
    device = torch.device(args.device)

    cfg = get_config(args.arch)
    if args.scale == "tiny":
        cfg = tiny_config(cfg)

    model = M.Model(cfg, generator=torch.Generator(device).manual_seed(0),
                    device=device)
    params = dict(model.named_parameters())
    n_params = sum(p.numel() for p in params.values())
    print(f"[train] arch={cfg.name} scale={args.scale} params={n_params:,}",
          flush=True)

    ocfg = optim.AdamWConfig(warmup_steps=5, decay_steps=max(args.steps, 10))
    opt_state = optim.init_opt_state(params)
    step_fn = make_train_step(model, ocfg, n_micro=args.n_micro,
                              remat=False, ce_chunks=2)

    start = 0
    writer = None
    if args.ckpt:
        writer = ckpt_mod.AsyncCheckpointer(args.ckpt)
        if args.resume == "auto":
            got, restored = ckpt_mod.restore_latest(
                args.ckpt, {"params": params, "opt": opt_state})
            if got is not None:
                with torch.no_grad():
                    for k, p in params.items():
                        p.copy_(restored["params"][k])
                opt_state = restored["opt"]
                start = got
                print(f"[train] resumed from step {got}", flush=True)

    extras = modality_extras(cfg, args.batch, args.seq, device)
    dcfg = DataConfig(batch_size=args.batch, seq_len=args.seq)
    t0 = time.perf_counter()
    with DataPipeline(dcfg, vocab_size=cfg.vocab_size) as pipe:
        for i, batch in enumerate(pipe.batches(args.steps - start),
                                  start=start + 1):
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in batch.items()}
            opt_state, metrics = step_fn(opt_state, dict(batch, **extras))
            if i % args.log_every == 0 or i == args.steps:
                loss = float(metrics["loss"])
                gn = float(metrics["grad_norm"])
                dt = time.perf_counter() - t0
                tput = args.batch * args.seq * args.log_every / max(dt, 1e-9)
                t0 = time.perf_counter()
                print(f"[train] step={i} loss={loss:.4f} "
                      f"grad_norm={gn:.3f} tok/s={tput:,.0f} "
                      f"skipped_batches={pipe.skipped}", flush=True)
                if not math.isfinite(loss):
                    raise SystemExit("loss diverged")
            if writer and (i % args.ckpt_every == 0 or i == args.steps):
                writer.save_async(i, {"params": params, "opt": opt_state})
    if writer:
        writer.close()
        print(f"[train] checkpoints in {args.ckpt}, "
              f"latest={ckpt_mod.latest_step(args.ckpt)}")
    print("[train] kernel launches: " + " ".join(
        f"{k}={n}" for k, n in kernel_launches().items()))
    print("[train] done")


if __name__ == "__main__":
    main()
