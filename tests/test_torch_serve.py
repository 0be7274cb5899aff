"""The port's serving launcher (`repro_torch.launch.serve`) on the CPU:
it prefills, decodes and swaps weights through the VersionedStore, and
in float32 it emits the token ids that the reference's serving steps emit
when fed the same weights (the port's init, converted to the
reference's pytree), for the dense, VLM, hybrid, ssm and MoE (MLA)
families."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro.serve import build_decode_step as ref_decode_step  # noqa: E402
from repro.serve import build_prefill_step as ref_prefill_step  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.data import batch_for  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serve import (Batcher, VersionedStore,  # noqa: E402
                               build_decode_step)

ARGS = ["--smoke", "--device", "cpu", "--swap-every", "4", "--batch", "2",
        "--prompt-len", "16", "--decode", "12"]


STACKED = ("blocks", "dense_blocks", "moe_blocks")


def to_reference(model) -> dict:
    """The port's `LM` as the reference's params pytree (numpy leaves,
    the leaves of a stacked group on leading layer axes: [L, ...], hybrid
    blocks [G, period, ...])."""
    tree, stacked = {}, {}

    def put(path, leaf):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf

    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[0] not in STACKED:
            put(parts, p.numpy())
            continue
        depth = 2 if (parts[0] == "blocks"
                      and model.cfg.family == "hybrid") else 1
        index = tuple(int(i) for i in parts[1:1 + depth])
        stacked.setdefault((parts[0],) + tuple(parts[1 + depth:]),
                           {})[index] = p.numpy()
    for path, leaves in stacked.items():
        lead = tuple(1 + max(ix[d] for ix in leaves)
                     for d in range(len(next(iter(leaves)))))
        put(path, np.stack([leaves[ix] for ix in np.ndindex(*lead)])
            .reshape(lead + next(iter(leaves.values())).shape))
    return tree


def ref_tokens(arch, params, batch, n_new):
    """The reference launcher's loop (`repro.launch.serve.main`) without
    its store: prefill, right-size the cache (n_patches + S + n_new
    positions), greedy decode."""
    rcfg = ref_configs.get_smoke_config(arch)
    B, S = batch["tokens"].shape
    logits, cache = jax.jit(ref_prefill_step(rcfg))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    full = ref_lm.make_cache(rcfg, B, rcfg.n_patches + S + n_new)
    cache = jax.tree.map(
        lambda z, c: jax.lax.dynamic_update_slice(
            z, c.astype(z.dtype), (0,) * z.ndim) if z.ndim else c,
        full, cache)
    tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
    decode = jax.jit(ref_decode_step(rcfg))
    out = [tok]
    for _ in range(n_new - 1):
        tok, cache = decode(params, tok, cache)
        out.append(tok)
    return np.asarray(jnp.concatenate(out, axis=1))


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-130m",
                                  "internvl2-2b", "zamba2-2.7b",
                                  "deepseek-v3-671b"])
def test_launcher_matches_reference_steps_in_f32(arch, monkeypatch, capsys):
    monkeypatch.setattr(ref_lm, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(lm, "COMPUTE_DTYPE", torch.float32)
    res = serve.main(["--arch", arch] + ARGS)
    assert res["version"] == 2            # swaps before decode steps 4, 8
    assert res["tokens"].shape == (2, 12)
    assert "store v2" in capsys.readouterr().out
    cfg = configs.get_smoke_config(arch)
    batch = batch_for(cfg, 2, 16, 0)
    want = ref_tokens(arch, to_reference(res["params"]), batch, 12)
    np.testing.assert_array_equal(res["tokens"].numpy(), want)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-130m",
                                  "internvl2-2b"])
def test_background_swap_lands_and_changes_no_token(arch):
    cfg = configs.get_smoke_config(arch)
    params = lm.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    batch = {k: torch.from_numpy(v)
             for k, v in batch_for(cfg, 3, 20, 0).items()}
    runs = []
    for background in (False, True):
        store = VersionedStore(params, n_workers=4, T_DC=1)
        toks, prefill_s, decode_s = serve.generate(
            cfg, store, batch, 10, swap_every=4, background_swap=background)
        assert store.version == 2 and prefill_s > 0 and decode_s > 0
        runs.append(toks)
    assert runs[0].shape == (3, 10) and runs[0].dtype == torch.int32
    assert torch.equal(runs[0], runs[1])


def test_generate_sizes_a_vlm_cache_past_its_patches(monkeypatch):
    """A VLM's prompt holds n_patches + S positions: the grown cache has
    room for n_new more (a cache of S + n_new would be written past its
    end)."""
    cfg = configs.get_smoke_config("internvl2_2b")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = {k: torch.from_numpy(v)
             for k, v in batch_for(cfg, 2, 6, 0).items()}
    totals = []
    grow = serve.grow_cache

    def spy(cfg_, cache, B, total):
        totals.append((int(cache["len"]), total))
        return grow(cfg_, cache, B, total)

    monkeypatch.setattr(serve, "grow_cache", spy)
    toks, _, _ = serve.generate(cfg, VersionedStore(params, n_workers=1,
                                                    T_DC=1), batch, 5)
    assert totals == [(cfg.n_patches + 6, cfg.n_patches + 6 + 5)]
    assert toks.shape == (2, 5)


@pytest.mark.parametrize("arch", ["deepseek_v3_671b", "zamba2_2p7b"])
def test_grow_cache_keeps_every_layout(arch):
    cfg = configs.get_smoke_config(arch)
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.from_numpy(batch_for(cfg, 2, 8, 0)["tokens"])
    with torch.no_grad():
        _, cache = lm.prefill(params, cfg, {"tokens": tokens})
    grown = serve.grow_cache(cfg, cache, 2, 13)
    want = lm.make_cache(cfg, 2, 13, device="cpu")
    assert {k: t.shape for k, t in grown.items()} == {
        k: t.shape for k, t in want.items()}
    for name, t in cache.items():
        if t.dim():
            assert torch.equal(grown[name][tuple(slice(0, n)
                                                 for n in t.shape)], t)
    assert not grown["k"][:, :, 8:].any()            # [L or G, B, S, ...]


def test_grow_cache_keeps_the_prefix():
    cfg = configs.get_smoke_config("qwen2_0p5b")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.from_numpy(batch_for(cfg, 2, 8, 0)["tokens"])
    with torch.no_grad():
        _, cache = lm.prefill(params, cfg, {"tokens": tokens})
    grown = serve.grow_cache(cfg, cache, 2, 13)
    assert grown["k"].shape[2] == 13 and int(grown["len"]) == 8
    assert torch.equal(grown["k"][:, :, :8], cache["k"])
    assert not grown["v"][:, :, 8:].any()


def test_batcher_pads_and_decodes():
    cfg = configs.get_smoke_config("mamba2_130m")
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    cache = lm.make_cache(cfg, 4, 8, device="cpu")
    nxt, cache = Batcher(build_decode_step(cfg), 4).run([5, 7], params,
                                                        cache)
    assert nxt.shape == (4, 1) and nxt.dtype == torch.int32
    assert int(cache["len"]) == 1


def test_launcher_refuses_encoder_and_unported_archs():
    """An encoder has no decode path (the reference's launcher exits the
    same way); an unknown arch raises."""
    with pytest.raises(SystemExit, match="encoder-only"):
        serve.main(["--arch", "hubert-xlarge", "--smoke", "--device", "cpu"])
    with pytest.raises(ValueError, match="unknown arch"):
        serve.main(["--arch", "gpt-2", "--smoke", "--device", "cpu"])
