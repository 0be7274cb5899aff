"""The port's serving launcher (`repro_torch.launch.serve`) on the CPU:
it prefills, decodes and swaps weights through the VersionedStore, and
in float32 it emits the token ids that the reference's serving steps emit
when fed the same weights (the port's init, converted to the
reference's pytree)."""
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


def to_reference(model) -> dict:
    """The port's `LM` as the reference's params pytree (numpy leaves,
    block leaves stacked on a leading layer axis)."""
    tree, blocks = {}, {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[0] == "blocks":
            blocks.setdefault(tuple(parts[2:]), []).append(p.numpy())
            continue
        node = tree
        for key in parts[:-1]:
            node = node.setdefault(key, {})
        node[parts[-1]] = p.numpy()
    node_root = tree.setdefault("blocks", {})
    for path, leaves in blocks.items():
        node = node_root
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.stack(leaves)
    return tree


def ref_tokens(arch, params, tokens, n_new):
    """The reference launcher's loop (`repro.launch.serve.main`) without
    its store: prefill, right-size the cache, greedy decode."""
    rcfg = ref_configs.get_smoke_config(arch)
    B, S = tokens.shape
    logits, cache = jax.jit(ref_prefill_step(rcfg))(
        params, {"tokens": jnp.asarray(tokens)})
    full = ref_lm.make_cache(rcfg, B, S + n_new)
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


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-130m"])
def test_launcher_matches_reference_steps_in_f32(arch, monkeypatch, capsys):
    monkeypatch.setattr(ref_lm, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(lm, "COMPUTE_DTYPE", torch.float32)
    res = serve.main(["--arch", arch] + ARGS)
    assert res["version"] == 2            # swaps before decode steps 4, 8
    assert res["tokens"].shape == (2, 12)
    assert "store v2" in capsys.readouterr().out
    cfg = configs.get_smoke_config(arch)
    tokens = batch_for(cfg, 2, 16, 0)["tokens"]
    want = ref_tokens(arch, to_reference(res["params"]), tokens, 12)
    np.testing.assert_array_equal(res["tokens"].numpy(), want)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-130m"])
def test_background_swap_lands_and_changes_no_token(arch):
    cfg = configs.get_smoke_config(arch)
    params = lm.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    tokens = torch.from_numpy(batch_for(cfg, 3, 20, 0)["tokens"])
    runs = []
    for background in (False, True):
        store = VersionedStore(params, n_workers=4, T_DC=1)
        toks, prefill_s, decode_s = serve.generate(
            cfg, store, tokens, 10, swap_every=4, background_swap=background)
        assert store.version == 2 and prefill_s > 0 and decode_s > 0
        runs.append(toks)
    assert runs[0].shape == (3, 10) and runs[0].dtype == torch.int32
    assert torch.equal(runs[0], runs[1])


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
    with pytest.raises(ValueError, match="ROADMAP.md"):
        serve.main(["--arch", "hubert-xlarge", "--smoke", "--device", "cpu"])
