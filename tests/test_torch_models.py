"""The port's LM substrate against the JAX reference, on the CPU: configs,
data, layers, every arch's model (dense, VLM, audio, MoE with MLA,
hybrid, ssm; SMOKE configs) with weights converted from the reference's
init, their full-width shapes and parameter counts, and the serving
store.

Model tolerances: with both packages computing in float32 (a test-local
patch of each `lm.COMPUTE_DTYPE`) 1e-4 and equal greedy tokens; in bf16
the reference's own 0.06 (tests/test_archs.py), decoding the reference's
tokens on both sides so that a bf16 near-tie cannot fork the streams.
In bf16 a one-ulp difference in an MoE router's logits can flip a top-k
choice: every routing difference between the packages must be such a
near-tie (`_routes_agree_up_to_ties`), and only the tokens that no
difference reaches are compared.
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
from repro.models import moe as ref_moe  # noqa: E402
from repro.serve import VersionedStore as RefStore  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import LockSpec  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.launch.serve import grow_cache  # noqa: E402
from repro_torch.models import convert, layers, lm, moe  # noqa: E402
from repro_torch.serve import VersionedStore, cache_shapes  # noqa: E402

ARCHS = list(configs.PORTED_ARCHS)
DECODERS = [a for a in ARCHS if configs.get_config(a).has_decode]
B, S, DECODE = 2, 16, 6


@pytest.fixture(scope="module")
def ref_params():
    """The reference's init of each SMOKE config (jitted: one program
    per arch compiles faster than its ops run eagerly)."""
    return {a: jax.jit(lambda k, cfg=ref_configs.get_smoke_config(a):
                       ref_lm.init_params(cfg, k))(jax.random.PRNGKey(0))
            for a in ARCHS}


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


def test_every_arch_is_ported():
    assert configs.PORTED_ARCHS == ref_configs.ARCH_IDS == configs.ARCH_IDS
    assert configs.ALIASES == ref_configs.ALIASES


@pytest.mark.parametrize("arch", ["gpt-2", "qwen2_0p5b_x"])
def test_unported_archs_name_the_roadmap(arch):
    """Every arch is ported: what still raises is an unknown name."""
    for get in (configs.get_config, configs.get_smoke_config):
        with pytest.raises(ValueError, match="unknown arch"):
            get(arch)


# ---------------------------------------------------------------- data
@pytest.mark.parametrize("arch,Bn,Sn,step,seed", [
    ("qwen2_0p5b", 2, 16, 0, 0), ("qwen2_0p5b", 4, 1024, 3, 1),
    ("mamba2_130m", 3, 33, 7, 2), ("mamba2_130m", 4, 1024, 0, 0),
    ("internvl2_2b", 2, 16, 0, 0), ("internvl2_2b", 4, 1024, 2, 3),
    ("hubert_xlarge", 2, 16, 0, 0), ("hubert_xlarge", 4, 1024, 5, 1),
    ("deepseek_v3_671b", 1, 64, 0, 0), ("zamba2_2p7b", 4, 1024, 0, 0)])
def test_batch_for_is_bit_equal(arch, Bn, Sn, step, seed):
    got = synthetic.batch_for(configs.get_config(arch), Bn, Sn, step,
                              seed=seed)
    want = ref_synthetic.batch_for(ref_configs.get_config(arch), Bn, Sn,
                                   step, seed=seed)
    assert set(got) == set(want)
    for name in want:
        assert got[name].dtype == want[name].dtype
        assert got[name].shape == want[name].shape
        np.testing.assert_array_equal(got[name], want[name])
    np.testing.assert_array_equal(synthetic._tok_block(seed, 0, 99, (Bn, 5)),
                                  ref_synthetic._tok_block(seed, 0, 99,
                                                           (Bn, 5)))


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_reference(arch):
    for shape in configs.SHAPES.values():
        for dtypes in ((torch.float32, jnp.float32),
                       (torch.bfloat16, jnp.bfloat16)):
            got = synthetic.input_specs(configs.get_config(arch), shape,
                                        dtypes[0])
            want = ref_synthetic.input_specs(ref_configs.get_config(arch),
                                             shape, dtypes[1])
            assert {k: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
                    for k, t in got.items()} == {
                k: (t.shape, str(t.dtype)) for k, t in want.items()}
            assert all(t.device.type == "meta" for t in got.values())


def test_synthetic_lm_streams_batch_for():
    cfg = configs.get_smoke_config("internvl2_2b")
    stream = synthetic.SyntheticLM(cfg, 2, 8, seed=3, start_step=5)
    try:
        for want_step in (5, 6, 7):
            step, batch = next(stream)
            assert step == want_step and stream.step == step + 1
            want = ref_synthetic.batch_for(ref_configs.get_smoke_config(
                "internvl2_2b"), 2, 8, step, seed=3)
            assert set(batch) == set(want) == {"tokens", "patches"}
            for name in want:
                np.testing.assert_array_equal(batch[name], want[name])
    finally:
        stream.close()
    assert not stream._thread.is_alive()


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
# Relative gap of two router scores that one bf16 ulp of their logits can
# close (bf16 keeps 8 significant bits; two ulps, one from each package).
ROUTE_TIE = 2.0 ** -6


def _batches(cfg, Bn, Sn, step):
    """batch_for's inputs as jnp arrays and as torch tensors."""
    nb = synthetic.batch_for(cfg, Bn, Sn, step)
    return ({k: jnp.asarray(v) for k, v in nb.items()},
            {k: torch.from_numpy(v) for k, v in nb.items()})


def _record_routes(monkeypatch):
    """Each package's MoE routings, (scores [T, E], experts [T, K]) per
    `_route` call in call order (the reference's through an ordered host
    callback, so inside jit and lax.scan too)."""
    seen = {"ref": [], "port": []}
    ref_route, port_route = ref_moe._route, moe._route

    def ref_wrap(scores, k):
        w, idx = ref_route(scores, k)
        jax.debug.callback(lambda a, i: seen["ref"].append(
            (np.asarray(a), np.asarray(i))), scores, idx, ordered=True)
        return w, idx

    def port_wrap(scores, k):
        w, idx = port_route(scores, k)
        seen["port"].append((scores.numpy().copy(), idx.numpy().copy()))
        return w, idx

    monkeypatch.setattr(ref_moe, "_route", ref_wrap)
    monkeypatch.setattr(moe, "_route", port_wrap)
    return seen


def _routes_agree_up_to_ties(seen, upto):
    """How many leading flat tokens (row-major over [B, S]) no routing
    difference between the packages reaches, of the first `upto`, over
    the MoE layers of the calls recorded in `seen` (in layer order: a
    difference at token t reaches every later token of every later
    layer, through causal attention and the capacity cumsum). Asserts
    that each difference among the tokens not yet reached is a near-tie:
    the two experts swapped at a top-k rank have scores within ROUTE_TIE
    of each other in both packages. Clears the records."""
    jax.effects_barrier()
    ref, port = seen["ref"], seen["port"]
    assert len(ref) == len(port) > 0
    for (rs, ri), (ps, pi) in zip(ref, port):
        assert ri.shape == pi.shape
        reached = upto
        for t, k in zip(*np.nonzero(ri[:upto] != pi[:upto])):
            a, b = ri[t, k], pi[t, k]
            for sc in (rs[t], ps[t]):
                gap = abs(float(sc[a]) - float(sc[b]))
                assert gap <= ROUTE_TIE * max(abs(float(sc[a])),
                                              abs(float(sc[b]))), (
                    f"token {t} rank {k}: experts {a} / {b} are not a "
                    f"near-tie (scores {sc[a]}, {sc[b]})")
            reached = min(reached, t)
        upto = reached
    ref.clear()
    port.clear()
    return upto


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
    ties = dtype == "bfloat16" and cfg.family == "moe"
    seen = _record_routes(monkeypatch) if ties else None
    rbatch, tbatch = _batches(cfg, B, S, 0)
    rl, rc = jax.jit(lambda p, b: ref_lm.prefill(p, rcfg, b))(rp, rbatch)
    with torch.no_grad():
        tl, tc = lm.prefill(model, cfg, tbatch)
    # Tokens (flat over [B, S']) that no routing difference reaches.
    Sp = tl.shape[1]
    upto = B * Sp
    if ties:
        upto = _routes_agree_up_to_ties(seen, upto)
    _close(tl.reshape(B * Sp, -1)[:upto], np.asarray(
        rl, np.float32).reshape(B * Sp, -1)[:upto], tol)
    assert set(tc) == set(rc)
    for name in rc:
        assert tuple(tc[name].shape) == rc[name].shape
        if upto == B * Sp:
            _close(tc[name], rc[name], tol)
    if not cfg.has_decode:
        assert set(tc) == {"len"} and int(tc["len"]) == S
        return

    total = cfg.n_patches + S + DECODE
    rcache = _ref_grow(rcfg, rc, total)
    tcache = grow_cache(cfg, tc, B, total)
    step = jax.jit(lambda p, t, c: ref_lm.decode_step(p, rcfg, t, c))
    rtok = jnp.argmax(rl[:, -1], -1).astype(jnp.int32)[:, None]
    ttok = tl[:, -1].float().argmax(-1)
    rows = upto // Sp                   # rows no routing difference reached
    for _ in range(DECODE):
        if dtype == "float32":
            np.testing.assert_array_equal(ttok.numpy(), np.asarray(rtok)[:, 0])
        rlg, rcache = step(rp, rtok, rcache)
        with torch.no_grad():
            tlg, tcache = lm.decode_step(model, cfg,
                                         torch.from_numpy(np.array(rtok)),
                                         tcache)
        if ties:
            rows = _routes_agree_up_to_ties(seen, rows)
        _close(tlg[:rows], np.asarray(rlg, np.float32)[:rows], tol)
        rtok = jnp.argmax(rlg[:, -1], -1).astype(jnp.int32)[:, None]
        ttok = tlg[:, -1].float().argmax(-1)
    assert int(tcache["len"]) == int(rcache["len"]) == total


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, ref_params, monkeypatch):
    tol = _compute_in("float32", monkeypatch)
    rcfg = ref_configs.get_smoke_config(arch)
    cfg = configs.get_smoke_config(arch)
    model = convert.from_reference(jax.tree.map(np.asarray,
                                                ref_params[arch]), cfg,
                                   device="cpu")
    rbatch, tbatch = _batches(cfg, B, 24, 1)
    want, _ = ref_lm.forward(ref_params[arch], rcfg, rbatch)
    with torch.no_grad():
        got = model(tbatch)
    _close(got, want, tol)


def _ref_shapes(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {".".join(str(k.key) for k in path): (tuple(leaf.shape),
                                                 str(leaf.dtype))
            for path, leaf in flat}


def _port_shapes(model):
    """The port's parameter shapes keyed as the reference's pytree: the
    per-layer modules of a stacked group (`blocks.3.attn.wq`, hybrid
    `blocks.1.4.mixer.D`) as one leaf with the layer axes in front."""
    stacked = {}
    for name, p in model.named_parameters():
        assert p.device.type == "meta"
        parts = name.split(".")
        axes = []
        while len(parts) > 1 and parts[1].isdigit() and (
                len(axes) == 0 or parts[0] == "blocks"):
            axes.append(int(parts.pop(1)))
            if parts[0] != "blocks" or model.cfg.family != "hybrid":
                break
        stacked.setdefault(".".join(parts), {})[tuple(axes)] = (
            tuple(p.shape), str(p.dtype).replace("torch.", ""))
    got = {}
    for name, entries in stacked.items():
        (shape, dtype), = set(entries.values())
        lead = tuple(1 + max(ix[d] for ix in entries)
                     for d in range(len(next(iter(entries)))))
        assert len(entries) == int(np.prod(lead))
        got[name] = (lead + shape, dtype)
    return got


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_param_shapes(arch):
    want = _ref_shapes(jax.eval_shape(
        lambda: ref_lm.init_params(ref_configs.get_config(arch),
                                   jax.random.PRNGKey(0))))
    assert _port_shapes(lm.init_params(configs.get_config(arch),
                                       device="meta")) == want


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_match_reference(arch):
    for get, ref_get in ((configs.get_config, ref_configs.get_config),
                         (configs.get_smoke_config,
                          ref_configs.get_smoke_config)):
        assert lm.param_counts(get(arch)) == ref_lm.param_counts(
            ref_get(arch))


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
