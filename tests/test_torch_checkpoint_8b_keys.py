"""SliME-8B checkpoint key sets and a bitwise round trip through the port
(mirrors ``tests/test_checkpoint_8b_keys.py``, whose independently built
expected key lists it reuses: the reference's module definitions, 32 LLM and
24 ViT layers, widths shrunk since key names depend on depth only).

- ``checkpoint.export_state_dict`` of the port's ``slime.init`` tree has
  exactly the SliME-8B key set, and equals JAX's export of the same values
  key for key;
- the staged-pretraining files carry exactly the projector's and the
  sampler's keys;
- save -> ``load_pretrained`` -> export reproduces every tensor bitwise.

Tolerance: none.
"""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from slime_tpu import checkpoint as jckpt
from slime_tpu.config import SliMEConfig as JCfg
from slime_tpu_torch import checkpoint as tckpt
from slime_tpu_torch import params as bridge
from slime_tpu_torch.config import LLMConfig, SliMEConfig
from slime_tpu_torch.models import slime

from .test_checkpoint_8b_keys import (N_LLM_LAYERS, N_VIT_LAYERS, expected_llm_keys,
                                      expected_projector_keys, expected_sampler_keys,
                                      expected_vision_keys)


@pytest.fixture(scope="module")
def model_8b_depth():
    tiny = SliMEConfig.tiny()
    cfg = dataclasses.replace(
        tiny, llm=dataclasses.replace(LLMConfig.tiny(), num_layers=N_LLM_LAYERS),
        vision=dataclasses.replace(tiny.vision, num_layers=N_VIT_LAYERS))
    assert cfg.mm_projector_type == "gated" and cfg.mm_resampler_type == "cosine"
    params = slime.init(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    return cfg, params


def _np(t):
    return t.to(torch.float32).numpy() if t.is_floating_point() else t.numpy()


def test_export_key_set_is_exactly_slime_8b_and_jax_s(model_8b_depth):
    cfg, params = model_8b_depth
    got = tckpt.export_state_dict(params, cfg)
    want = (expected_llm_keys() | expected_projector_keys() | expected_sampler_keys()
            | expected_vision_keys())
    assert sorted(set(want) - set(got)) == [] and sorted(set(got) - set(want)) == []
    jsd = jckpt.export_state_dict(bridge.to_jax_numpy(params),
                                  JCfg.from_json_dict(cfg.to_json_dict()))
    assert list(got) == list(jsd)
    for k, v in jsd.items():
        np.testing.assert_array_equal(_np(got[k]), np.asarray(v, np.float32), err_msg=k)


def test_adapter_files_carry_exact_key_sets(model_8b_depth, tmp_path):
    cfg, params = model_8b_depth
    adir = str(tmp_path / "adapters")
    tckpt.save_checkpoint(adir, params, cfg, adapters_only=True)
    mm = torch.load(os.path.join(adir, "mm_projector.bin"), weights_only=True)
    assert set(mm) == expected_projector_keys()
    samp = torch.load(os.path.join(adir, "sampler.bin"), weights_only=True)
    assert set(samp) == expected_sampler_keys()


def test_bitwise_roundtrip_through_save_and_all_key_groups(model_8b_depth, tmp_path):
    cfg, params = model_8b_depth
    d = str(tmp_path / "full")
    tckpt.save_checkpoint(d, params, cfg)
    before = tckpt.export_state_dict(params, cfg)
    after = tckpt.export_state_dict(tckpt.load_pretrained(d, cfg=cfg), cfg)
    assert set(before) == set(after)
    bad = [k for k in before if not np.array_equal(_np(before[k]), _np(after[k]))]
    assert not bad, f"{len(bad)} tensors changed in the round trip: {bad[:8]}"
