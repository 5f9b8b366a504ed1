"""Parameter bridge (slime_tpu_torch.params) and the port's random inits.

The bridge must carry the JAX package's parameter trees bit for bit (bf16,
int8, fp32, list and stacked layers), and each port ``init`` must produce the
JAX ``init``'s key set and shapes, so a tree moves between the packages.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from slime_tpu.config import LLMConfig, SliMEConfig, VisionConfig
from slime_tpu.models import llama as jllama
from slime_tpu.models import slime as jslime
from slime_tpu.ops.quantization import quantize_weight as jquantize
from slime_tpu_torch import params as bridge
from slime_tpu_torch.data.image_ops import make_device_anyres_fn
from slime_tpu_torch.models import llama as tllama
from slime_tpu_torch.models import projector as tproj
from slime_tpu_torch.models import resampler as tres
from slime_tpu_torch.models import sampler as tsamp
from slime_tpu_torch.models import slime as tslime
from slime_tpu_torch.models import vit as tvit


def _cfg():
    return SliMEConfig(
        llm=LLMConfig(vocab_size=256, hidden_size=64, intermediate_size=128,
                      num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
                      max_position_embeddings=1024),
        vision=VisionConfig(image_size=336, patch_size=14, hidden_size=256,
                            intermediate_size=512, num_layers=3, num_heads=4),
        mm_resampler_dim=4, seperator=7, tokenizer_model_max_length=700,
        bos_token_id=1, eos_token_id=2)


def _flat(tree, prefix=""):
    """{path: (shape, dtype name)} of a nested dict/list tree."""
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        path = f"{prefix}/{k}"
        if isinstance(v, (dict, list)):
            out.update(_flat(v, path))
        else:
            out[path] = (tuple(v.shape), str(v.dtype).replace("torch.", ""))
    return out


def _jax_tree():
    """JAX params with every leaf kind the bridge meets: bf16 and fp32 dense,
    int8 quant dicts, stacked layers."""
    cfg = _cfg()
    p = jax.device_get(jslime.init(jax.random.PRNGKey(0), cfg))
    p["vision"] = jax.tree_util.tree_map(lambda a: a.astype(ml_dtypes.bfloat16),
                                         p["vision"])
    for lp in p["llm"]["layers"]:
        for k in ("q_proj", "gate_proj"):
            lp[k]["weight"] = jax.device_get(jquantize(lp[k]["weight"], 8))
    p["llm"]["layers"] = jax.device_get(jllama.stack_layers(p["llm"]["layers"]))
    return p


def _assert_bit_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.dtype == ml_dtypes.bfloat16:
        a, b = a.view(np.uint16), b.view(np.uint16)
    np.testing.assert_array_equal(a, b)


def test_bridge_round_trip_is_bit_exact():
    tree = _jax_tree()
    back = bridge.to_jax_numpy(bridge.from_jax_numpy(tree, device="cpu"))
    flat_a = jax.tree_util.tree_leaves_with_path(tree)
    flat_b = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_a, flat_b):
        _assert_bit_equal(a, b)


def test_bridge_dtypes_and_layouts():
    tree = _jax_tree()
    t = bridge.from_jax_numpy(tree, device="cpu")
    ql = t["llm"]["layers"]["q_proj"]["weight"]
    assert ql["q"].dtype == torch.int8 and ql["q"].shape == (2, 64, 64)
    assert ql["scale"].dtype == torch.float32 and ql["scale"].shape == (2, 64, 1)
    assert t["vision"]["layers"][0]["fc1"]["weight"].dtype == torch.bfloat16
    assert t["llm"]["norm"]["weight"].dtype == torch.float32
    # dtype casts float leaves but keeps int8 and the fp32 quant scales
    c = bridge.from_jax_numpy(tree, device="cpu", dtype=torch.bfloat16)
    cq = c["llm"]["layers"]["q_proj"]["weight"]
    assert cq["q"].dtype == torch.int8 and cq["scale"].dtype == torch.float32
    assert c["llm"]["norm"]["weight"].dtype == torch.bfloat16
    # list-of-layers layout survives too
    lst = bridge.from_jax_numpy({"layers": [{"w": np.ones((2, 3), np.float32)}] * 2},
                                device="cpu")
    assert isinstance(lst["layers"], list) and lst["layers"][1]["w"].shape == (2, 3)


def test_port_init_matches_jax_key_set_and_shapes():
    cfg = _cfg()
    jp = jax.device_get(jslime.init(jax.random.PRNGKey(0), cfg))
    tp = tslime.init(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    fj, ft = _flat(jp), _flat(tp)
    assert fj.keys() == ft.keys()
    for k in fj:
        assert fj[k] == ft[k], k
    # bf16 init gives bf16 weights with the same keys
    tb = tslime.init(cfg, generator=torch.Generator().manual_seed(0), device="cpu",
                     dtype=torch.bfloat16)
    assert _flat(tb).keys() == fj.keys()
    assert tb["llm"]["embed_tokens"].dtype == torch.bfloat16


def test_port_init_is_seeded():
    cfg = _cfg()
    a = tslime.init(cfg, generator=torch.Generator().manual_seed(3), device="cpu")
    b = tslime.init(cfg, generator=torch.Generator().manual_seed(3), device="cpu")
    torch.testing.assert_close(a["vision"]["patch_embedding"],
                               b["vision"]["patch_embedding"], rtol=0, atol=0)
    assert not jnp.array_equal(
        np.asarray(a["llm"]["embed_tokens"]),
        np.asarray(tslime.init(cfg, generator=torch.Generator().manual_seed(4),
                               device="cpu")["llm"]["embed_tokens"]))


ENTRY_POINTS = {
    "slime.init": lambda: tslime.init(_cfg(), generator=torch.Generator()),
    "llama.init": lambda: tllama.init(_cfg().llm, generator=torch.Generator()),
    "llama.init_kv_cache": lambda: tllama.init_kv_cache(_cfg().llm, 1, 8),
    "llama.rope_table": lambda: tllama.rope_table(_cfg().llm, 16),
    "vit.init": lambda: tvit.init(_cfg().vision, generator=torch.Generator()),
    "projector.init": lambda: tproj.init(_cfg(), generator=torch.Generator()),
    "sampler.init": lambda: tsamp.init(_cfg(), generator=torch.Generator()),
    "resampler.init": lambda: tres.init(grid_size=4, embed_dim=32, generator=torch.Generator()),
    "params.from_jax_numpy": lambda: bridge.from_jax_numpy({"w": np.ones(3, np.float32)}),
    "make_device_anyres_fn": lambda: make_device_anyres_fn((112, 112), tile=56),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_default_to_the_card(monkeypatch, name):
    """With no device given, an entry point puts its tensors on the current
    CUDA device; without a card it raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ENTRY_POINTS[name]()
