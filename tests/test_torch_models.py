"""The port's LM substrate against the JAX reference, on the CPU: configs,
data, layers, the dense (Qwen2-0.5B) and ssm (Mamba2-130M) models with
weights converted from the reference's init, their full-width shapes, and
the serving store.

Model tolerances: with both packages computing in float32 (a test-local
patch of each `lm.COMPUTE_DTYPE`) 1e-4 and equal greedy tokens; in bf16
the reference's own 0.06 (tests/test_archs.py), decoding the reference's
tokens on both sides so that a bf16 near-tie cannot fork the streams.
"""
import dataclasses
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.core import LockSpec as RefSpec  # noqa: E402
from repro.data import synthetic as ref_synthetic  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro.serve import VersionedStore as RefStore  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import LockSpec  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.launch.serve import grow_cache  # noqa: E402
from repro_torch.models import convert, layers, lm  # noqa: E402
from repro_torch.serve import VersionedStore, cache_shapes  # noqa: E402

ARCHS = list(configs.PORTED_ARCHS)
UNPORTED = [a for a in configs.ARCH_IDS if a not in ARCHS]
B, S, DECODE = 2, 16, 6


@pytest.fixture(scope="module")
def ref_params():
    return {a: ref_lm.init_params(ref_configs.get_smoke_config(a),
                                  jax.random.PRNGKey(0)) for a in ARCHS}


def _compute_in(dtype, monkeypatch):
    if dtype == "float32":
        monkeypatch.setattr(ref_lm, "COMPUTE_DTYPE", jnp.float32)
        monkeypatch.setattr(lm, "COMPUTE_DTYPE", torch.float32)
    return 1e-4 if dtype == "float32" else 0.06


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _ref_grow(rcfg, cache, total):
    full = ref_lm.make_cache(rcfg, B, total)
    return jax.tree.map(
        lambda z, c: jax.lax.dynamic_update_slice(
            z, c.astype(z.dtype), (0,) * z.ndim) if z.ndim else c,
        full, cache)


# ------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_the_reference_configs(arch):
    for get, ref_get in ((configs.get_config, ref_configs.get_config),
                         (configs.get_smoke_config,
                          ref_configs.get_smoke_config)):
        assert (dataclasses.asdict(get(arch))
                == dataclasses.asdict(ref_get(arch)))
    alias = next(k for k, v in configs.ALIASES.items() if v == arch)
    assert configs.get_config(alias) == configs.get_config(arch)


@pytest.mark.parametrize("arch", UNPORTED)
def test_unported_archs_name_the_roadmap(arch):
    for get in (configs.get_config, configs.get_smoke_config):
        with pytest.raises(ValueError, match="ROADMAP.md"):
            get(arch)


# ---------------------------------------------------------------- data
@pytest.mark.parametrize("arch,Bn,Sn,step,seed", [
    ("qwen2_0p5b", 2, 16, 0, 0), ("qwen2_0p5b", 4, 1024, 3, 1),
    ("mamba2_130m", 3, 33, 7, 2), ("mamba2_130m", 4, 1024, 0, 0)])
def test_batch_for_is_bit_equal(arch, Bn, Sn, step, seed):
    got = synthetic.batch_for(configs.get_config(arch), Bn, Sn, step,
                              seed=seed)
    want = ref_synthetic.batch_for(ref_configs.get_config(arch), Bn, Sn,
                                   step, seed=seed)
    assert set(got) == set(want) == {"tokens"}
    assert got["tokens"].dtype == want["tokens"].dtype == np.int32
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    np.testing.assert_array_equal(synthetic._tok_block(seed, 0, 99, (Bn, 5)),
                                  ref_synthetic._tok_block(seed, 0, 99,
                                                           (Bn, 5)))


# -------------------------------------------------------------- layers
@pytest.mark.parametrize("kind", ["rmsnorm", "nonparam_ln", "layernorm"])
def test_norms_match_reference(kind):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 32).astype(np.float32)
    p = {"w": rng.randn(32).astype(np.float32),
         "b": rng.randn(32).astype(np.float32)}
    got = layers.apply_norm(torch.from_numpy(x),
                            {k: torch.from_numpy(v) for k, v in p.items()},
                            kind)
    want = ref_layers.apply_norm(jnp.asarray(x), p, kind)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("kind,bias", [("swiglu", False), ("gelu", True)])
def test_mlp_matches_reference(kind, bias):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 5, 16).astype(np.float32)
    p = {k: rng.randn(*shape).astype(np.float32) for k, shape in
         (("w_gate", (16, 24)), ("w_up", (16, 24)), ("w_down", (24, 16)),
          ("b_up", (24,)), ("b_down", (16,)))
         if bias or not k.startswith("b_")}
    got = layers.mlp_apply({k: torch.from_numpy(v) for k, v in p.items()},
                           torch.from_numpy(x), kind)
    _close(got, ref_layers.mlp_apply(p, jnp.asarray(x), kind), 1e-4)


def test_rope_matches_reference():
    rng = np.random.RandomState(2)
    x = rng.randn(2, 7, 3, 16).astype(np.float32)
    pos = np.broadcast_to(np.arange(7) + 1000, (2, 7))
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos.copy()),
                            1e6)
    _close(got, ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6),
           2e-5)


# -------------------------------------------------------------- models
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, dtype, ref_params,
                                            monkeypatch):
    tol = _compute_in(dtype, monkeypatch)
    rcfg = ref_configs.get_smoke_config(arch)
    cfg = configs.get_smoke_config(arch)
    rp = ref_params[arch]
    model = convert.from_reference(jax.tree.map(np.asarray, rp), cfg,
                                   device="cpu")
    tokens = synthetic.batch_for(cfg, B, S, 0)["tokens"]
    rl, rc = jax.jit(lambda p, t: ref_lm.prefill(p, rcfg, {"tokens": t}))(
        rp, jnp.asarray(tokens))
    with torch.no_grad():
        tl, tc = lm.prefill(model, cfg, {"tokens": torch.from_numpy(tokens)})
    _close(tl, rl, tol)
    assert set(tc) == set(rc)
    for name in rc:
        assert tuple(tc[name].shape) == rc[name].shape
        _close(tc[name], rc[name], tol)

    rcache = _ref_grow(rcfg, rc, S + DECODE)
    tcache = grow_cache(cfg, tc, B, S + DECODE)
    step = jax.jit(lambda p, t, c: ref_lm.decode_step(p, rcfg, t, c))
    rtok = jnp.argmax(rl[:, -1], -1).astype(jnp.int32)[:, None]
    ttok = tl[:, -1].float().argmax(-1)
    for _ in range(DECODE):
        if dtype == "float32":
            np.testing.assert_array_equal(ttok.numpy(), np.asarray(rtok)[:, 0])
        rlg, rcache = step(rp, rtok, rcache)
        with torch.no_grad():
            tlg, tcache = lm.decode_step(model, cfg,
                                         torch.from_numpy(np.array(rtok)),
                                         tcache)
        _close(tlg, rlg, tol)
        rtok = jnp.argmax(rlg[:, -1], -1).astype(jnp.int32)[:, None]
        ttok = tlg[:, -1].float().argmax(-1)
    assert int(tcache["len"]) == int(rcache["len"]) == S + DECODE


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, ref_params, monkeypatch):
    tol = _compute_in("float32", monkeypatch)
    rcfg = ref_configs.get_smoke_config(arch)
    cfg = configs.get_smoke_config(arch)
    model = convert.from_reference(jax.tree.map(np.asarray,
                                                ref_params[arch]), cfg,
                                   device="cpu")
    tokens = synthetic.batch_for(cfg, B, 24, 1)["tokens"]
    want, _ = ref_lm.forward(ref_params[arch], rcfg,
                             {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        got = model(torch.from_numpy(tokens))
    _close(got, want, tol)


def _ref_shapes(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {".".join(str(k.key) for k in path): (tuple(leaf.shape),
                                                 str(leaf.dtype))
            for path, leaf in flat}


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_param_shapes(arch):
    cfg = configs.get_config(arch)
    want = _ref_shapes(jax.eval_shape(
        lambda: ref_lm.init_params(ref_configs.get_config(arch),
                                   jax.random.PRNGKey(0))))
    model = lm.init_params(cfg, device="meta")
    per_layer = {}
    got = {}
    for name, p in model.named_parameters():
        assert p.device.type == "meta"
        entry = (tuple(p.shape), str(p.dtype).replace("torch.", ""))
        if name.startswith("blocks."):
            _, _, leaf = name.split(".", 2)
            per_layer.setdefault(f"blocks.{leaf}", []).append(entry)
        else:
            got[name] = entry
    for name, entries in per_layer.items():
        assert len(entries) == cfg.n_layers and len(set(entries)) == 1
        got[name] = ((cfg.n_layers,) + entries[0][0], entries[0][1])
    assert got == want


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_cache_shapes(arch):
    rcfg = ref_configs.get_config(arch)
    want = _ref_shapes(jax.eval_shape(lambda: ref_lm.make_cache(rcfg, 4,
                                                                1056)))
    got = {k: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
           for k, t in cache_shapes(configs.get_config(arch), 4,
                                    1056).items()}
    assert got == want


def test_init_draws_from_the_generator():
    cfg = configs.get_smoke_config("qwen2_0p5b")
    a, b, c = (lm.init_params(cfg, torch.Generator().manual_seed(s), "cpu")
               for s in (0, 0, 1))
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(),
                                                 b.parameters()))
    assert not torch.equal(a.embed.tok, c.embed.tok)
    with pytest.raises(ValueError, match="Generator"):
        lm.init_params(cfg, device="cpu")


# --------------------------------------------------------------- store
def test_store_swap_drains_readers():
    store = VersionedStore({"w": 0}, n_workers=4, T_DC=2)
    order = []

    def reader(wid, hold):
        with store.reader_view(wid) as (params, ver):
            order.append(("r_in", wid, ver))
            time.sleep(hold)
            order.append(("r_out", wid, ver))

    threads = [threading.Thread(target=reader, args=(i, 0.15))
               for i in range(4)]
    for t in threads:
        t.start()
    time.sleep(0.03)
    assert store.swap({"w": 1}) == 1            # must drain all 4 readers
    for t in threads:
        t.join(timeout=5)
        assert not t.is_alive()
    assert len(order) == 8 and all(ver == 0 for _, _, ver in order)
    with store.reader_view(0) as (params, ver):
        assert ver == 1 and params["w"] == 1


@pytest.mark.parametrize("P,T_DC", [(8, 4), (8, 3), (16, 1), (5, 2),
                                    (64, 16), (1, 1)])
def test_store_counters_match_reference(P, T_DC):
    got = VersionedStore({}, n_workers=P, T_DC=T_DC)
    want = RefStore({}, n_workers=P, T_DC=T_DC)
    assert got.n_counters == want.n_counters
    assert ([got.counter_of(w) for w in range(2 * P)]
            == [want.counter_of(w) for w in range(2 * P)])


def test_store_from_spec_matches_reference():
    kw = dict(kind="rma_rw", P=64, fanout=(4,), T_DC=16, T_L=(4, 4),
              T_R=64, writer_fraction=0.02)
    got = VersionedStore.from_spec({"w": 0}, LockSpec(**kw))
    want = RefStore.from_spec({"w": 0}, RefSpec(**kw))
    assert got.n_counters == want.n_counters == 4
    assert ([got.counter_of(w) for w in range(64)]
            == [want.counter_of(w) for w in range(64)])
    assert got.swap({"w": 1}) == 1
    with got.reader_view(63) as (params, ver):
        assert ver == 1 and params["w"] == 1


def test_store_reader_fallback_on_dead_writer():
    store = VersionedStore({"w": 1}, n_workers=4, T_DC=2, writer_lease=0.05)
    assert store.swap({"w": 2}) == 1 and store.recoveries == 0
    for c in store._counters:             # a swapper that died mid-swap
        c.write_mode = True
    store._swap_started = time.monotonic() - 1.0
    with store.reader_view(0) as (params, version):
        assert params == {"w": 2} and version == 1
    assert store.recoveries == 1
    other = next(i for i in range(4)
                 if store.counter_of(i) != store.counter_of(0))
    with store.reader_view(other) as (params, _):
        assert params == {"w": 2}
    assert store.recoveries == 2
