"""The port's model path against the JAX package's, on the CPU.

For each of the ten architectures (the attention-only qwen2-0.5b,
olmo-1b, granite-20b, gemma3-12b and qwen2-vl-7b; the Mamba-1
falcon-mamba-7b; the hybrid zamba2-1.2b, Mamba-2 layers around one shared
attention block; the moe granite-moe-3b-a800m and qwen2-moe-a2.7b, the
latter with shared experts; the encoder-decoder whisper-small, fed the
same random frames for its encoder at ``forward`` and ``prefill``) at the
conftest ``tiny`` size in float32, the
JAX package's ``init_params`` tree is perturbed in numpy (QKV biases and
norm scales away from their zero/one initial values, so those paths
compute something) and carried into the port with
``params_from_reference``.  The same tokens then go through both:
``forward`` logits, ``prefill`` logits and cache, four ``decode_step``s
from the grown cache with the same fed tokens (past gemma3's window of 8:
its local layers decode on a ring), the same steps from the JAX package's
own cache carried across with ``cache_from_reference``, and greedy
``decode_multi`` tokens.
Every cache leaf is compared too: K/V and the ssm layers' conv and scan
states.  Tolerance atol = rtol = 1e-4 (float32 throughout, sums in another
order; the Mamba-1 scan runs sequentially where the reference runs a
chunked associative scan, and the tiny falcon-mamba and zamba2 logits and
states still agree within about 6e-6); greedy tokens must be identical.
On the CPU the port's attention and scan run the kernels' plain versions,
and the JAX package its jnp path.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as JM
from repro_torch.configs import base as TB
from repro_torch.models import model as TM
from repro_torch.models.convert import cache_from_reference, params_from_reference

from conftest import tiny

ARCHS = ("qwen2-0.5b", "olmo-1b", "granite-20b", "gemma3-12b", "qwen2-vl-7b",
         "falcon-mamba-7b", "zamba2-1.2b", "granite-moe-3b-a800m",
         "qwen2-moe-a2.7b", "whisper-small")
TOL = dict(atol=1e-4, rtol=1e-4)
B, S, N_DEC = 2, 12, 4


def port_config(jcfg) -> TB.ModelConfig:
    """The port's twin of a JAX package config, field by field."""
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    for sub, cls in (("moe", TB.MoEConfig), ("ssm", TB.SSMConfig),
                     ("encdec", TB.EncDecConfig)):
        if kw[sub] is not None:
            kw[sub] = cls(**dataclasses.asdict(kw[sub]))
    return TB.ModelConfig(**kw)


def perturb(tree, rng):
    """Biases to N(0, 0.1) and norm scales to 1 + N(0, 0.1)."""
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out[key] = perturb(val, rng)
        elif key in ("bq", "bk", "bv", "bias", "b_up", "b_down"):
            out[key] = rng.normal(0.0, 0.1, val.shape).astype(val.dtype)
        elif key == "scale":
            out[key] = (1.0 + rng.normal(0.0, 0.1, val.shape)).astype(val.dtype)
        else:
            out[key] = val
    return out


def mrope(start, length):
    """Distinct t/h/w streams [3, B, length] from absolute positions."""
    p = np.arange(start, start + length)
    thw = np.stack([p, p // 2, p % 3]).astype(np.int32)
    return np.broadcast_to(thw[:, None], (3, B, length)).copy()


def frames(cfg, seed: int = 7):
    """Random encoder frames [B, T, d] for whisper's family, float32."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal(
        (B, cfg.encdec.n_encoder_ctx, cfg.d_model)).astype(np.float32)


def leaves(tree, prefix=""):
    for key, val in sorted(tree.items()):
        if isinstance(val, dict):
            yield from leaves(val, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", val


def clone(cache):
    return {k: clone(v) if isinstance(v, dict) else v.clone()
            for k, v in cache.items()}


@pytest.fixture(scope="module", params=ARCHS)
def both(request):
    """Everything each package computes for one architecture."""
    jcfg = tiny(request.param)
    tcfg = port_config(jcfg)
    rng = np.random.default_rng(0)
    tree = perturb(jax.tree.map(np.asarray,
                                JM.init_params(jax.random.PRNGKey(0), jcfg)),
                   rng)
    jparams = jax.tree.map(jnp.asarray, tree)
    model = params_from_reference(tree, tcfg, "cpu")
    toks = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    fed = rng.integers(0, jcfg.vocab_size, (N_DEC, B, 1)).astype(np.int32)
    vlm, audio = jcfg.family == "vlm", jcfg.family == "audio"
    enc = frames(jcfg) if audio else None

    def extras(start, length, lib):
        """M-RoPE positions for qwen2-vl; the frames for whisper's forward
        and prefill (its decode reads the cross K/V from the cache)."""
        conv = jnp.asarray if lib == "jax" else torch.from_numpy
        if vlm:
            return {"mrope_positions": conv(mrope(start, length))}
        if audio and start == 0:
            return {"frames": conv(enc)}
        return {}

    j_fwd = jax.jit(JM.forward, static_argnums=(1,))
    j_pre = jax.jit(JM.prefill, static_argnums=(1,))
    j_step = jax.jit(JM.decode_step, static_argnums=(1,))
    j_multi = jax.jit(JM.decode_multi, static_argnums=(1, 5))
    specs = JM.cache_specs(jcfg, B, S + N_DEC)

    out = {"jax": {}, "torch": {}}
    # JAX package
    o = out["jax"]
    o["forward"] = np.asarray(j_fwd(jparams, jcfg, toks, extras(0, S, "jax"))[0])
    logits, cache = j_pre(jparams, jcfg, toks, extras(0, S, "jax"))
    o["prefill"], o["prefill_cache"] = np.asarray(logits), cache
    cache = jax.tree.map(lambda c, s: jnp.pad(
        c, [(0, d - g) for g, d in zip(c.shape, s.shape)]), cache, specs)
    grown = cache
    o["grown"] = jax.tree.map(np.asarray, grown)
    o["steps"] = []
    for i in range(N_DEC):
        logits, cache = j_step(jparams, jcfg, fed[i], cache, jnp.int32(S + i),
                               extras(S + i, 1, "jax"))
        o["steps"].append(np.asarray(logits))
    o["step_cache"] = cache
    first = np.asarray(o["prefill"][:, 0, :jcfg.vocab_size].argmax(-1),
                       np.int32)[:, None]
    toks_j, cache_j, clen_j = j_multi(jparams, jcfg, first, grown,
                                      jnp.int32(S), N_DEC, extras(S, 1, "jax"))
    o["multi"], o["multi_cache"], o["multi_len"] = (np.asarray(toks_j),
                                                   cache_j, int(clen_j))

    # the port
    o = out["torch"]
    tt = torch.from_numpy(toks)
    with torch.no_grad():
        o["forward"] = model(tt, extras(0, S, "torch")).numpy()
    logits, cache = model.prefill(tt, extras(0, S, "torch"))
    o["prefill"], o["prefill_cache"] = logits.numpy(), clone(cache)
    grown = TM.grow_cache(cache, tcfg, B, S + N_DEC)
    cache = clone(grown)
    o["steps"] = []
    for i in range(N_DEC):
        logits, cache = model.decode_step(torch.from_numpy(fed[i]), cache,
                                          S + i, extras(S + i, 1, "torch"))
        o["steps"].append(logits.numpy())
    o["step_cache"] = cache
    toks_t, cache_t, clen_t = model.decode_multi(
        torch.from_numpy(first), grown, S, N_DEC, extras(S, 1, "torch"))
    o["multi"], o["multi_cache"], o["multi_len"] = (toks_t.numpy(), cache_t,
                                                   int(clen_t))
    out["cfg"], out["model"], out["fed"], out["extras"] = (tcfg, model, fed,
                                                           extras)
    return out


def test_forward_logits_match(both):
    np.testing.assert_allclose(both["torch"]["forward"], both["jax"]["forward"],
                               **TOL)


def test_prefill_logits_and_cache_match(both):
    np.testing.assert_allclose(both["torch"]["prefill"], both["jax"]["prefill"],
                               **TOL)
    got = dict(leaves(both["torch"]["prefill_cache"]))
    want = dict(leaves(both["jax"]["prefill_cache"]))
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(np.asarray(got[key]), np.asarray(want[key]),
                                   **TOL, err_msg=key)


def test_decode_steps_match_past_the_window(both):
    for i, (got, want) in enumerate(zip(both["torch"]["steps"],
                                        both["jax"]["steps"])):
        np.testing.assert_allclose(got, want, **TOL, err_msg=f"step {i}")
    got = dict(leaves(both["torch"]["step_cache"]))
    for key, want in leaves(both["jax"]["step_cache"]):
        np.testing.assert_allclose(np.asarray(got[key]), np.asarray(want),
                                   **TOL, err_msg=key)
    if both["cfg"].sliding_window is not None:   # the ring wrapped
        assert S + N_DEC > both["cfg"].sliding_window


def test_decode_multi_tokens_identical(both):
    np.testing.assert_array_equal(both["torch"]["multi"], both["jax"]["multi"])
    assert both["torch"]["multi_len"] == both["jax"]["multi_len"] == S + N_DEC
    got = dict(leaves(both["torch"]["multi_cache"]))
    for key, want in leaves(both["jax"]["multi_cache"]):
        np.testing.assert_allclose(np.asarray(got[key]), np.asarray(want),
                                   **TOL, err_msg=key)


def test_decode_multi_equals_stepwise_greedy(both):
    """Fused greedy decode == a loop of decode_step + argmax (the port's
    own check, as tests/test_decode_multi.py does for the reference)."""
    cfg = both["cfg"]
    model = TM.Model(cfg, generator=torch.Generator().manual_seed(1),
                     device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (B, S), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(0))
    ext = ({"mrope_positions": torch.from_numpy(mrope(0, S))}
           if cfg.family == "vlm" else {})
    if cfg.family == "audio":
        ext = {"frames": torch.from_numpy(frames(cfg))}
    step_ext = ({"mrope_positions": torch.from_numpy(mrope(S, 1))}
                if cfg.family == "vlm" else {})
    logits, cache = model.prefill(toks, ext)
    cache = TM.grow_cache(cache, cfg, B, S + N_DEC)
    first = logits[:, 0, :cfg.vocab_size].argmax(-1).to(torch.int32)[:, None]
    fused, _, _ = model.decode_multi(first, clone(cache), S, N_DEC, step_ext)
    tok, seq = first, []
    for i in range(N_DEC):
        lg, cache = model.decode_step(tok, cache, S + i, step_ext)
        tok = lg[:, 0, :cfg.vocab_size].argmax(-1).to(torch.int32)[:, None]
        seq.append(tok[:, 0])
    assert torch.equal(fused, torch.stack(seq, 1))


def test_decode_multi_eos_masking():
    cfg = port_config(tiny("olmo-1b"))
    model = TM.Model(cfg, generator=torch.Generator().manual_seed(2),
                     device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (1, 4), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(3))
    logits, cache = model.prefill(toks)
    cache = TM.grow_cache(cache, cfg, 1, 10)
    first = logits[:, 0, :cfg.vocab_size].argmax(-1).to(torch.int32)[:, None]
    free, _, _ = model.decode_multi(first, clone(cache), 4, 6)
    eos = int(free[0, 1])
    masked, _, _ = model.decode_multi(first, cache, 4, 6, eos_id=eos)
    stop = int(np.argmax(free[0].numpy() == eos))
    assert masked[0, :stop + 1].tolist() == free[0, :stop + 1].tolist()
    assert (masked[0, stop:] == eos).all()


def test_cache_specs_match_prefill(both):
    specs = {k: tuple(t.shape)
             for k, t in leaves(TM.cache_specs(both["cfg"], B, S))}
    got = {k: tuple(t.shape) for k, t in leaves(both["torch"]["prefill_cache"])}
    assert specs == got


def test_model_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = port_config(tiny("qwen2-0.5b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.Model(cfg, generator=torch.Generator())
    with pytest.raises(ValueError, match="Generator"):
        TM.Model(cfg, device="cpu")


def test_cache_from_reference_keeps_the_tree(both):
    tree = jax.tree.map(np.asarray, both["jax"]["prefill_cache"])
    got = cache_from_reference(tree, "cpu")
    assert [k for k, _ in leaves(tree)] == [k for k, _ in leaves(got)]
    for (_, a), (_, b) in zip(leaves(tree), leaves(got)):
        np.testing.assert_array_equal(a, b.numpy())


def test_decode_from_the_reference_cache(both):
    """The JAX package's own grown prefill cache, carried across with
    ``cache_from_reference``, decodes in the port to the JAX package's
    logits, step for step (past gemma3's window)."""
    cache = cache_from_reference(both["jax"]["grown"], "cpu")
    for i, want in enumerate(both["jax"]["steps"]):
        logits, cache = both["model"].decode_step(
            torch.from_numpy(both["fed"][i]), cache, S + i,
            both["extras"](S + i, 1, "torch"))
        np.testing.assert_allclose(logits.numpy(), want, **TOL,
                                   err_msg=f"step {i}")


def test_quickstart_runs_on_the_cpu():
    import os
    import subprocess
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.quickstart", "--device",
         "cpu", "--arch", "gemma3-12b", "--new-tokens", "4"],
        capture_output=True, text=True, timeout=300, cwd=root,
        env=dict(os.environ, PYTHONPATH=str(root / "src")))
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "generated ids:" in proc.stdout and proc.stdout.endswith("ok\n")


def run_quickstart(arch: str) -> str:
    from repro_torch.launch import quickstart
    import contextlib
    import io
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        quickstart.main(["--device", "cpu", "--arch", arch,
                         "--new-tokens", "3"])
    return out.getvalue()


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-1.2b"])
def test_quickstart_runs_the_ssm_archs_on_the_cpu(arch):
    text = run_quickstart(arch)
    assert f"arch={arch}" in text and text.endswith("ok\n")


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "qwen2-moe-a2.7b",
                                  "whisper-small"])
def test_quickstart_runs_the_moe_and_audio_archs_on_the_cpu(arch):
    """The moe archs, and whisper with zero frames for its encoder."""
    text = run_quickstart(arch)
    assert f"arch={arch}" in text and text.endswith("ok\n")


def test_convert_carries_the_ssm_and_shared_leaves():
    """In bfloat16, ``params_from_reference`` fills zamba2's top-level
    ``shared_block``, every Mamba-2 leaf, and the float32 leaves ``D``,
    ``dt_bias`` and ``A_log`` bit for bit."""
    jcfg = tiny("zamba2-1.2b").scaled(dtype="bfloat16")
    tree = jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(0),
                                                   jcfg))
    model = params_from_reference(tree, port_config(jcfg), "cpu")
    got = dict(model.named_parameters())
    assert any(k.startswith("shared_block.attn.") for k in got)
    want = {}
    for key, val in leaves(tree):
        stage, _, rest = key.partition(".")
        if stage in ("hybrid", "hybrid_tail"):
            for p in range(val.shape[0]):
                want[f"stages.{stage}.{p}.{rest}"] = val[p]
        else:
            want[key] = val
    assert got.keys() == want.keys()
    for key, val in want.items():
        t = got[key].detach()
        assert str(t.dtype).split(".")[-1] == str(val.dtype), key
        np.testing.assert_array_equal(t.float().numpy(),
                                      val.astype(np.float32), err_msg=key)
    assert got["stages.hybrid.0.layer1.ssm.A_log"].dtype == torch.float32


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "whisper-small"])
def test_convert_carries_the_moe_and_whisper_leaves(arch):
    """In bfloat16, ``params_from_reference`` fills every leaf of the moe
    layers (router, experts, shared experts and their gate) and of
    whisper (the encoder stage, ``enc_norm``, ``norm_x`` and ``cross``)
    bit for bit, the router float32; a missing or an extra leaf raises."""
    jcfg = tiny(arch).scaled(dtype="bfloat16")
    tree = jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(0),
                                                   jcfg))
    model = params_from_reference(tree, port_config(jcfg), "cpu")
    got = dict(model.named_parameters())
    stages = {s.name for s in JM.build_plan(jcfg)}
    want = {}
    for key, val in leaves(tree):
        stage, _, rest = key.partition(".")
        if stage in stages:
            for p in range(val.shape[0]):
                want[f"stages.{stage}.{p}.{rest}"] = val[p]
        else:
            want[key] = val
    assert got.keys() == want.keys()
    for key, val in want.items():
        t = got[key].detach()
        assert str(t.dtype).split(".")[-1] == str(val.dtype), key
        np.testing.assert_array_equal(t.float().numpy(),
                                      val.astype(np.float32), err_msg=key)
    names = set(got)
    if arch == "whisper-small":
        assert "enc_norm.scale" in names
        assert {"stages.encoder.0.layer0.attn.wq",
                "stages.decoder.0.layer0.cross.bk",
                "stages.decoder.0.layer0.norm_x.bias"} <= names
    else:
        router = got["stages.moe.0.layer0.moe.router"]
        assert router.dtype == torch.float32
        assert {"stages.moe.0.layer0.shared_gate",
                "stages.moe.0.layer0.shared_mlp.w_down",
                "stages.moe.0.layer0.moe.w_gate"} <= names
    stage = sorted(stages)[-1]
    short = dict(tree, **{stage: {k: v for k, v in tree[stage].items()
                                  if k != "layer0"}})
    with pytest.raises(KeyError, match="no reference weights"):
        params_from_reference(short, port_config(jcfg), "cpu")
    extra = dict(tree, stray=np.zeros(3, np.float32))
    with pytest.raises(KeyError, match="no parameter"):
        params_from_reference(extra, port_config(jcfg), "cpu")


def test_quickstart_without_a_card_raises(monkeypatch):
    from repro_torch.launch import quickstart
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        quickstart.main([])
