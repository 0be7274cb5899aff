"""The port's training path against the JAX reference, on the CPU: the
learning-rate schedules, AdamW, `loss_fn` and its gradients for every
family, train steps continued from a converted reference state, remat,
the bf16 gradient barrier, the eval step, and the attention and SSD
kernels' autograd Functions.

Inputs are numpy arrays from fixed seeds handed to both packages;
weights and train states go across through `models.convert`.
Tolerances: with both packages computing in float32 (a test-local patch
of each `lm.COMPUTE_DTYPE`) 1e-4, relative to each tensor's largest
magnitude (the gradients differ by summation order only: <= 1.3e-5
measured); in bf16 the reference's own 0.06 (tests/test_archs.py) on the
loss and on each gradient's norm-relative error (<= 0.024 measured on
Qwen2's SMOKE config: the packages round to bf16 at other places);
schedules and AdamW, the same float32 ops, 1e-6.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro import optim as ref_optim  # noqa: E402
from repro.data import synthetic as ref_synthetic  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro.models import ssm as ref_ssm  # noqa: E402
from repro.train import step as ref_step  # noqa: E402
from repro_torch import configs, optim  # noqa: E402
from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.kernels import flash_attention as fa_mod  # noqa: E402
from repro_torch.kernels import ssd_scan as ssd_mod  # noqa: E402
from repro_torch.models import convert, lm  # noqa: E402
from repro_torch.train import step  # noqa: E402
from tests.test_system import TINY as REF_TINY  # noqa: E402

TINY = ArchConfig(**dataclasses.asdict(REF_TINY))
# The loss's families: dense (TINY), ssm, MoE with MLA and MTP, audio
# labels, the VLM patch prefix, hybrid.
ARCHS = ["tiny", "mamba2_130m", "deepseek_v3_671b", "hubert_xlarge",
         "internvl2_2b", "zamba2_2p7b"]
B, S = 2, 16
F32_TOL, BF16_TOL, OPT_TOL = 1e-4, 0.06, 1e-6


def _cfgs(arch):
    if arch == "tiny":
        return REF_TINY, TINY
    return ref_configs.get_smoke_config(arch), configs.get_smoke_config(arch)


def _batch(arch, step_=0):
    """(reference batch, port batch) of `arch` for `step_`."""
    np_batch = ref_synthetic.batch_for(_cfgs(arch)[0], B, S, step_)
    return (jax.tree.map(jnp.asarray, np_batch),
            {k: torch.from_numpy(v) for k, v in np_batch.items()})


@pytest.fixture(scope="module")
def ref_states():
    """The reference's initial train state of each arch (jitted: one
    program per arch compiles faster than its ops run eagerly)."""
    return {a: jax.jit(lambda k, c=_cfgs(a)[0]: ref_step.init_state(c, k))(
        jax.random.PRNGKey(0)) for a in ARCHS}


def _port_state(ref_state, arch):
    return convert.state_from_reference(jax.tree.map(np.asarray, ref_state),
                                        _cfgs(arch)[1], "cpu")


@pytest.fixture
def f32(monkeypatch):
    monkeypatch.setattr(ref_lm, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(lm, "COMPUTE_DTYPE", torch.float32)


def _close(got, want, tol):
    """|got - want| <= tol * max(1, max |want|), elementwise."""
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _params_close(port_tree, ref_tree, cfg, tol):
    """Every leaf of a port params-like dict/module against the
    reference's tree of the same structure."""
    want = dict(convert.from_reference(
        jax.tree.map(lambda a: np.asarray(a, np.float32), ref_tree), cfg,
        "cpu").named_parameters())
    got = optim.adamw.named_leaves(port_tree)
    assert set(got) == set(want)
    for k, w in want.items():
        _close(got[k], w.detach().numpy(), tol)


def _grads(params):
    return {k: torch.zeros_like(p) if p.grad is None else p.grad
            for k, p in params.named_parameters()}


# ------------------------------------------------------------ schedules
@pytest.mark.parametrize("warmup,total,final", [(0, 10, 0.1), (5, 40, 0.1),
                                                (100, 10_000, 0.0),
                                                (7, 3, 0.25)])
def test_schedules_match_reference(warmup, total, final):
    steps = np.unique(np.clip(np.concatenate([
        np.arange(12), np.linspace(0, 2 * total, 40).astype(int),
        [warmup - 1, warmup, warmup + 1, total - 1, total]]), 0, None))
    for s in steps.astype(np.int32):
        got = optim.linear_warmup_cosine(torch.tensor(s), warmup, total,
                                         final)
        want = ref_optim.linear_warmup_cosine(jnp.int32(s), warmup, total,
                                              final)
        _close(got, want, OPT_TOL)
        _close(optim.cosine_schedule(int(s), total, final),
               ref_optim.cosine_schedule(jnp.int32(s), total, final),
               OPT_TOL)


# ---------------------------------------------------------------- AdamW
@pytest.mark.parametrize("cfg_kw,lr_scale", [
    ({}, 1.0),
    (dict(grad_clip=0.05, weight_decay=0.0), 0.37),       # clipping
    (dict(lr=1e-2, b1=0.8, b2=0.99, grad_clip=1e3), 0.5)])
def test_adamw_update_matches_reference(cfg_kw, lr_scale):
    rng = np.random.RandomState(len(cfg_kw))
    shapes = {"a": (3, 5), "b": (7,), "c/d": (2, 3, 4), "e": ()}
    params, grads, m, v = ({k: np.asarray(rng.randn(*s) * sc, np.float32)
                            for k, s in shapes.items()}
                           for sc in (1.0, 0.3, 0.1, 1.0))
    v = {k: np.abs(a) * np.float32(0.01) for k, a in v.items()}
    ref_cfg = ref_optim.AdamWConfig(**cfg_kw)
    ref_state = ref_optim.adamw.AdamWState(
        step=jnp.int32(4), m=jax.tree.map(jnp.asarray, m),
        v=jax.tree.map(jnp.asarray, v))
    want_u, want_s, want_n = ref_optim.adamw_update(
        jax.tree.map(jnp.asarray, grads), ref_state,
        jax.tree.map(jnp.asarray, params), ref_cfg, lr_scale=lr_scale)
    want_p = ref_optim.apply_updates(jax.tree.map(jnp.asarray, params),
                                     want_u)

    t = lambda tree: {k: torch.tensor(a) for k, a in tree.items()}
    port_p = t(params)
    state = optim.AdamWState(step=torch.tensor(4, dtype=torch.int32),
                             m=t(m), v=t(v))
    got_u, got_s, got_n = optim.adamw_update(t(grads), state, port_p,
                                             optim.AdamWConfig(**cfg_kw),
                                             lr_scale=lr_scale)
    _close(got_n, want_n, OPT_TOL)
    _close(optim.global_norm(t(grads)), ref_optim.global_norm(
        jax.tree.map(jnp.asarray, grads)), OPT_TOL)
    assert int(got_s.step) == int(want_s.step) == 5
    optim.apply_updates(port_p, got_u)
    for k in shapes:
        for got, want in ((got_u[k], want_u[k]), (got_s.m[k], want_s.m[k]),
                          (got_s.v[k], want_s.v[k]), (port_p[k], want_p[k])):
            assert got.dtype == torch.float32
            _close(got, want, OPT_TOL)


# ------------------------------------------------------------ the loss
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch, ref_states, f32):
    ref_cfg, cfg = _cfgs(arch)
    rb, tb = _batch(arch)
    (want, want_m), want_g = jax.jit(jax.value_and_grad(
        lambda p: ref_lm.loss_fn(p, ref_cfg, rb), has_aux=True))(
        ref_states[arch].params)
    params = _port_state(ref_states[arch], arch).params
    got, got_m = lm.loss_fn(params, cfg, tb)
    got.backward()
    _close(got, want, F32_TOL)
    _close(got_m["aux"], want_m["aux"], F32_TOL)
    assert (float(got_m["aux"].detach()) > 0) == (cfg.family == "moe")
    _params_close(_grads(params), want_g, cfg, F32_TOL)


def test_loss_and_grads_bf16_match_reference():
    """bf16 compute on Qwen2-0.5B's SMOKE config."""
    arch = "qwen2_0p5b"
    ref_cfg, cfg = _cfgs(arch)
    ref_state = jax.jit(lambda k: ref_step.init_state(ref_cfg, k))(
        jax.random.PRNGKey(0))
    rb, tb = _batch(arch)
    (want, _), want_g = jax.jit(jax.value_and_grad(
        lambda p: ref_lm.loss_fn(p, ref_cfg, rb), has_aux=True))(
        ref_state.params)
    params = _port_state(ref_state, arch).params
    got, _ = lm.loss_fn(params, cfg, tb)
    got.backward()
    assert abs(float(got.detach()) - float(want)) <= BF16_TOL
    want_g = dict(convert.from_reference(
        jax.tree.map(lambda a: np.asarray(a, np.float32), want_g), cfg,
        "cpu").named_parameters())
    for k, p in params.named_parameters():
        err = float((p.grad - want_g[k]).norm() / want_g[k].norm())
        assert err <= BF16_TOL, (k, err)


# ------------------------------------------------------------ the steps
@pytest.mark.parametrize("arch", ["tiny", "mamba2_130m"])
def test_train_steps_continue_a_converted_reference_state(arch, ref_states,
                                                          f32):
    """One reference step (so AdamW's moments and step are not zero),
    the state converted, then three steps in each package on the same
    batches: metrics and the whole state agree."""
    ref_cfg, cfg = _cfgs(arch)
    kw = dict(remat="dots", warmup_steps=2, total_steps=6)
    ref_fn = jax.jit(ref_step.build_train_step(ref_cfg, **kw))
    port_fn = step.build_train_step(cfg, **kw)
    rs, _ = ref_fn(ref_states[arch], _batch(arch, 0)[0])
    ps = _port_state(rs, arch)
    for i in range(1, 4):
        rb, tb = _batch(arch, i)
        rs, want = ref_fn(rs, rb)
        ps, got = port_fn(ps, tb)
        assert set(got) == set(want) == {"loss", "aux", "grad_norm",
                                         "lr_scale"}
        for k in want:
            _close(got[k], want[k], F32_TOL)
    assert int(ps.step) == int(rs.step) == int(ps.opt.step) == 4
    _params_close(ps.params, rs.params, cfg, F32_TOL)
    _params_close(ps.opt.m, rs.opt.m, cfg, F32_TOL)
    _params_close(ps.opt.v, rs.opt.v, cfg, F32_TOL)


@pytest.mark.parametrize("arch", ["qwen2_0p5b", "zamba2_2p7b",
                                  "deepseek_v3_671b"])
def test_remat_variants_give_equal_gradients(arch, f32):
    """none / dots / full recompute the same ops on the CPU: the loss and
    every gradient are bit for bit equal."""
    cfg = configs.get_smoke_config(arch)
    _, tb = _batch(arch)
    out = {}
    for remat in ("none", "dots", "full"):
        params = lm.make_trainable(lm.init_params(
            cfg, torch.Generator().manual_seed(0), "cpu"))
        loss, _ = lm.loss_fn(params, cfg, tb, remat=remat)
        loss.backward()
        out[remat] = (loss.detach(), _grads(params))
    for remat in ("dots", "full"):
        assert torch.equal(out[remat][0], out["none"][0])
        for k, g in out["none"][1].items():
            assert torch.equal(out[remat][1][k], g), (remat, k)
    with pytest.raises(ValueError, match="remat"):
        lm.loss_fn(params, cfg, tb, remat="some")


def test_bf16_grad_sync_matches_reference(ref_states, f32):
    """grad_sync_dtype="bf16": every gradient AdamW reads is bf16-rounded,
    and the step agrees with the reference's."""
    arch = "tiny"
    ref_cfg, cfg = _cfgs(arch)
    kw = dict(remat="none", warmup_steps=0, total_steps=10,
              grad_sync_dtype="bf16")
    rs, want = jax.jit(ref_step.build_train_step(ref_cfg, **kw))(
        ref_states[arch], _batch(arch)[0])
    ps, got = step.build_train_step(cfg, **kw)(_port_state(
        ref_states[arch], arch), _batch(arch)[1])
    for k in want:
        _close(got[k], want[k], F32_TOL)
    _params_close(ps.params, rs.params, cfg, F32_TOL)
    for p in ps.params.parameters():
        assert p.grad.dtype == torch.float32
        assert torch.equal(p.grad, p.grad.bfloat16().float())
    with pytest.raises(ValueError, match="grad_sync_dtype"):
        step.build_train_step(cfg, grad_sync_dtype="fp8")


def test_eval_step_matches_reference(ref_states, f32):
    arch = "deepseek_v3_671b"
    ref_cfg, cfg = _cfgs(arch)
    rb, tb = _batch(arch)
    want = jax.jit(ref_step.build_eval_step(ref_cfg))(ref_states[arch], rb)
    ps = _port_state(ref_states[arch], arch)
    got = step.build_eval_step(cfg)(ps, tb)
    assert got.dtype == torch.float32 and not got.requires_grad
    _close(got, want, F32_TOL)
    assert all(p.grad is None for p in ps.params.parameters())


def test_init_state_is_trainable_and_zeroed():
    st = step.init_state(TINY, torch.Generator().manual_seed(0), "cpu")
    names = [k for k, _ in st.params.named_parameters()]
    assert all(p.requires_grad for p in st.params.parameters())
    assert list(st.opt.m) == list(st.opt.v) == names
    assert all(not bool(t.any()) for t in (*st.opt.m.values(),
                                           *st.opt.v.values()))
    assert int(st.step) == int(st.opt.step) == 0
    assert st.step.dtype == st.opt.step.dtype == torch.int32
    # Serving's params stay frozen.
    served = lm.init_params(TINY, torch.Generator().manual_seed(0), "cpu")
    assert not any(p.requires_grad for p in served.parameters())


# ------------------------------------------------- the kernels' gradients
ATTN_CASES = [  # B, Sq, Skv, H, KV, dh, causal, window, dtype
    (2, 40, 40, 4, 2, 16, True, None, "float32"),
    (1, 70, 70, 4, 1, 32, True, 24, "float32"),
    (2, 24, 56, 2, 2, 16, False, None, "float32"),
    (1, 72, 72, 4, 2, 64, True, None, "bfloat16"),         # P in bf16
]


def _attn_inputs(B_, Sq, Skv, H, KV, dh, dtype):
    rng = np.random.RandomState(Sq + dh)
    return [rng.randn(b_, s_, h_, dh).astype(np.float32) for b_, s_, h_ in
            ((B_, Sq, H), (B_, Skv, KV), (B_, Skv, KV))] + [
        rng.randn(B_, Sq, H, dh).astype(np.float32)]


@pytest.mark.parametrize("B_,Sq,Skv,H,KV,dh,causal,win,dtype", ATTN_CASES)
def test_flash_attention_function_gradients(B_, Sq, Skv, H, KV, dh, causal,
                                            win, dtype):
    """Through `FlashAttentionFn` (forward the wrapper's launch, here the
    plain version; backward the plain version under autograd) equal to
    autograd through `flash_attention_plain`; in f32 also the reference's
    gradient of `multihead_attention`, the function it differentiates."""
    *qkv, g = _attn_inputs(B_, Sq, Skv, H, KV, dh, dtype)
    dt = getattr(torch, dtype)

    def grads(fn):
        ts = [torch.from_numpy(a).to(dt).requires_grad_() for a in qkv]
        out = fn(*ts, causal=causal, window=win)
        out.backward(torch.from_numpy(g).to(dt))
        return out, [t.grad for t in ts]

    out, got = grads(fa_mod.flash_attention)
    assert out.grad_fn is not None and "FlashAttentionFn" in type(
        out.grad_fn).__name__
    out_p, want = grads(fa_mod.flash_attention_plain)
    assert torch.equal(out, out_p)
    for a, b in zip(got, want):
        assert a.dtype == dt and torch.equal(a, b)
    if dtype == "float32":
        ref = jax.jit(jax.grad(lambda q, k, v: jnp.sum(
            ref_layers.multihead_attention(q, k, v, causal=causal,
                                           window=win) * g),
            argnums=(0, 1, 2)))(*map(jnp.asarray, qkv))
        for a, b in zip(got, ref):
            _close(a, b, F32_TOL)
    with torch.no_grad():
        ts = [torch.from_numpy(a).to(dt).requires_grad_() for a in qkv]
        assert fa_mod.flash_attention(*ts, causal=causal,
                                      window=win).grad_fn is None


@pytest.mark.parametrize("b,S_,H,P,N,chunk", [(2, 32, 3, 8, 6, 8),
                                             (1, 48, 2, 4, 5, 16),
                                             (2, 16, 2, 6, 4, 16)])
def test_ssd_scan_function_gradients(b, S_, H, P, N, chunk):
    """Through `SSDScanFn` equal to autograd through `ssd_scan_plain`,
    with cotangents on y and on the final state, and to the reference's
    gradient of `ssd_chunked`."""
    rng = np.random.RandomState(S_ + N)
    ins = [rng.randn(b, S_, H, P), rng.rand(b, S_, H) * 0.5 + 0.01,
           -(rng.rand(H) * 4 + 0.5), rng.randn(b, S_, N), rng.randn(b, S_, N)]
    ins = [a.astype(np.float32) for a in ins]
    gy = rng.randn(b, S_, H, P).astype(np.float32)
    gs = rng.randn(b, H, P, N).astype(np.float32)

    def grads(fn):
        ts = [torch.from_numpy(a).requires_grad_() for a in ins]
        y, s = fn(*ts, chunk=chunk)
        torch.autograd.backward((y, s), (torch.from_numpy(gy),
                                         torch.from_numpy(gs)))
        return (y, s), [t.grad for t in ts]

    out, got = grads(ssd_mod.ssd_scan)
    assert "SSDScanFn" in type(out[0].grad_fn).__name__
    _, want = grads(ssd_mod.ssd_scan_plain)
    for a, w in zip(got, want):
        assert torch.equal(a, w)
    def ref_loss(*a):
        y, s = ref_ssm.ssd_chunked(*a, chunk)
        return jnp.sum(y * gy) + jnp.sum(s * gs)

    ref = jax.jit(jax.grad(ref_loss, argnums=(0, 1, 2, 3, 4)))(
        *map(jnp.asarray, ins))
    for a, w in zip(got, ref):
        _close(a, w, F32_TOL)
