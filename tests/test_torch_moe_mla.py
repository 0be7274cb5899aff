"""The port's MoE and MLA layers against the JAX reference, on the CPU
(SMOKE configs of DeepSeek-V3 and Arctic, parameters from the
reference's init): `moe_apply` with both router kinds (outputs, aux loss
and the routing: top-k experts, kept pairs), with and without dropped
tokens; the stable top-k on ties; MLA's naive prefill and absorbed
decode. Everything in float32 at 1e-4 (outputs) and exactly (routing).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.models import mla as ref_mla  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import mla, moe  # noqa: E402

MOE_ARCHS = ["deepseek_v3_671b", "arctic_480b"]


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree, np.float32))


def _close(got, want, tol=1e-4):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


@pytest.fixture(scope="module")
def moe_params():
    return {a: ref_moe.init_moe(jax.random.PRNGKey(1),
                                ref_configs.get_smoke_config(a))
            for a in MOE_ARCHS}


def _ref_keep(gate_i, E, C):
    """The reference's dispatch positions (`repro.models.moe.moe_apply`'s
    lines), for the routing it returned."""
    flat_e = gate_i.reshape(-1)
    onehot = jax.nn.one_hot(flat_e, E, dtype=jnp.int32)
    pos = jnp.cumsum(onehot, axis=0) - onehot
    pos = jnp.take_along_axis(pos, flat_e[:, None], axis=1)[:, 0]
    keep = pos < C
    return keep, jnp.where(keep, flat_e * C + pos, E * C)


@pytest.mark.parametrize("cf", [None, 0.5, 4.0])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_apply_matches_reference(arch, cf, moe_params, monkeypatch):
    cfg = configs.get_smoke_config(arch)
    rcfg = ref_configs.get_smoke_config(arch)
    rp = moe_params[arch]
    x = np.random.RandomState(3).randn(3, 16, cfg.d_model).astype(np.float32)
    routes = {"ref": [], "port": []}
    for mod, key in ((ref_moe, "ref"), (moe, "port")):
        route = mod._route

        def wrap(scores, k, route=route, key=key):
            out = route(scores, k)
            routes[key].append(out)
            return out
        monkeypatch.setattr(mod, "_route", wrap)
    want, want_aux = ref_moe.moe_apply(rp, jnp.asarray(x), rcfg,
                                       capacity_factor=cf)
    got, aux = moe.moe_apply(_torch_tree(rp), torch.from_numpy(x), cfg,
                             capacity_factor=cf)
    _close(got, want)
    _close(aux, want_aux)
    (rw, ri), (w, i) = routes["ref"][0], routes["port"][0]
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    _close(w, rw, 1e-6)
    E, K, T = cfg.n_experts, cfg.top_k, x.shape[0] * x.shape[1]
    C = max(1, int(np.ceil(T * K / E * (cf or cfg.capacity_factor))))
    keep, slot = moe.dispatch_slots(i, E, C)
    rkeep, rslot = _ref_keep(ri, E, C)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(rkeep))
    np.testing.assert_array_equal(slot.numpy(), np.asarray(rslot))
    if cf == 0.5:
        assert not keep.all()                 # some pairs were dropped
    if cf == 4.0:
        assert keep.all()


def test_route_breaks_ties_as_lax_top_k():
    rng = np.random.RandomState(0)
    scores = rng.randint(0, 4, (64, 16)).astype(np.float32)  # many ties
    for k in (1, 2, 8, 16):
        w, i = moe._route(torch.from_numpy(scores), k)
        rw, ri = jax.lax.top_k(jnp.asarray(scores), k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
        np.testing.assert_array_equal(w.numpy(), np.asarray(rw))


def test_experts_in_groups_equal_one_product(moe_params, monkeypatch):
    """Casting the experts group by group (a full-width layer never holds
    all of them in the compute dtype) gives the same products."""
    cfg = configs.get_smoke_config("deepseek_v3_671b")
    p = _torch_tree(moe_params["deepseek_v3_671b"])
    buf = torch.from_numpy(np.random.RandomState(5).randn(
        cfg.n_experts, 6, cfg.d_model).astype(np.float32)).bfloat16()
    whole = moe._experts(p, buf)
    per_expert = 3 * cfg.d_model * cfg.moe_d_ff * 2
    monkeypatch.setattr(moe, "EXPERT_GROUP_BYTES", 3 * per_expert)
    assert torch.equal(moe._experts(p, buf), whole)


@pytest.fixture(scope="module")
def mla_params():
    return ref_mla.init_mla(jax.random.PRNGKey(2), ref_configs.get_smoke_config(
        "deepseek_v3_671b"))


def test_mla_apply_matches_reference(mla_params):
    cfg = configs.get_smoke_config("deepseek_v3_671b")
    rcfg = ref_configs.get_smoke_config("deepseek_v3_671b")
    x = np.random.RandomState(4).randn(2, 24, cfg.d_model).astype(np.float32)
    want, (rc, rkr) = ref_mla.mla_apply(mla_params, jnp.asarray(x), rcfg)
    got, (c, kr) = mla.mla_apply(_torch_tree(mla_params),
                                 torch.from_numpy(x), cfg)
    for g, w in ((got, want), (c, rc), (kr, rkr)):
        assert tuple(g.shape) == w.shape
        _close(g, w)


@pytest.mark.parametrize("length", [0, 7, 19])
def test_mla_decode_matches_reference(mla_params, length):
    cfg = configs.get_smoke_config("deepseek_v3_671b")
    rcfg = ref_configs.get_smoke_config("deepseek_v3_671b")
    rng = np.random.RandomState(length)
    B, S = 2, 24
    x = rng.randn(B, 1, cfg.d_model).astype(np.float32)
    cc = rng.randn(B, S, cfg.kv_lora_rank).astype(np.float32)
    ckr = rng.randn(B, S, cfg.qk_rope_dim).astype(np.float32)
    want, (rcc, rckr) = ref_mla.mla_decode(
        mla_params, jnp.asarray(x), rcfg, jnp.asarray(cc), jnp.asarray(ckr),
        jnp.int32(length))
    tcc, tckr = torch.from_numpy(cc.copy()), torch.from_numpy(ckr.copy())
    got, (gcc, gckr) = mla.mla_decode(
        _torch_tree(mla_params), torch.from_numpy(x), cfg, tcc, tckr,
        torch.tensor(length, dtype=torch.int32))
    _close(got, want)
    assert gcc is tcc and gckr is tckr                   # written in place
    _close(gcc, rcc)
    _close(gckr, rckr)
