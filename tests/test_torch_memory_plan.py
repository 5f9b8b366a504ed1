"""The port's memory plan against the JAX package's, field by field.

``plan`` (Llama-3-8B, Llama-3-70B) and ``plan_mm`` (SliME-70B) equal JAX's
``MemoryPlan`` exactly, every field, over the meshes of
``tests/test_memory_plan.py`` ((1, 8, 4, 4) among them) and a few more, at
``grad_accum_steps`` 1 and 4, with ``loss_chunk`` at its default and None;
``fit_table`` equals JAX's; ``composed.check_composed``'s bytes (rank 0's
shards of a tree on the meta device) equal ``plan(...).params`` and
``plan_mm(...).params``, and it raises where JAX's trace would. The trees
behind the port's plan live on the meta device (no storage). JAX's abstract
inits are traced once per config (``jax.eval_shape`` memoized for the
module), which changes none of its numbers.
"""
import dataclasses

import pytest
import torch

from slime_tpu_torch.config import LLMConfig, SliMEConfig
from slime_tpu_torch.parallel import composed
from slime_tpu_torch.parallel import memory_plan as mp
from slime_tpu_torch.params import named_leaves

# (n_data, n_fsdp, n_model, n_pp)
MESHES = [(1, 1, 1, 1), (1, 4, 2, 2), (1, 8, 4, 4), (1, 4, 4, 4), (1, 16, 4, 4),
          (1, 8, 1, 1), (2, 2, 2, 4), (1, 3, 3, 5)]
CONFIGS = {"llama3_8b": (LLMConfig.llama3_8b, "plan"),
           "llama3_70b": (LLMConfig.llama3_70b, "plan"),
           "slime_70b": (SliMEConfig.slime_70b, "plan_mm")}


def _kw(mesh):
    return dict(zip(("n_data", "n_fsdp", "n_model", "n_pp"), mesh))


@pytest.fixture(scope="module")
def jax_plans():
    """JAX's plan function and config by name, jax.eval_shape memoized."""
    import jax

    from slime_tpu.config import LLMConfig as JL
    from slime_tpu.config import SliMEConfig as JS
    from slime_tpu.parallel import memory_plan as jmp

    saved, memo = jax.eval_shape, {}

    def eval_shape(fn, *args):
        key = (fn.__code__, tuple(c.cell_contents for c in fn.__closure__ or ()), args)
        if key not in memo:
            memo[key] = saved(fn, *args)
        return memo[key]

    jax.eval_shape = eval_shape
    try:
        yield jmp, {"llama3_8b": JL.llama3_8b(), "llama3_70b": JL.llama3_70b(),
                    "slime_70b": JS.slime_70b()}
    finally:
        jax.eval_shape = saved


@pytest.mark.parametrize("name", list(CONFIGS))
def test_plan_equals_jax(jax_plans, name):
    jmp, jcfgs = jax_plans
    make, fn = CONFIGS[name]
    cfg = make()
    for mesh in MESHES:
        for accum in (1, 4):
            for chunk in ("default", None):
                kw = dict(_kw(mesh), batch=32, grad_accum_steps=accum, loss_chunk=chunk)
                got = getattr(mp, fn)(cfg, **kw)
                want = getattr(jmp, fn)(jcfgs[name], **kw)
                assert dataclasses.asdict(got) == dataclasses.asdict(want), (name, kw)
                assert got.fits(16 * 2 ** 30) == want.fits(16 * 2 ** 30)
                assert got.fits(80 * 2 ** 30) == want.fits(80 * 2 ** 30)
        if (cfg.llm if fn == "plan_mm" else cfg).num_layers % mesh[3] == 0:
            rows = 2 * mesh[3] * mesh[0] * mesh[1]     # splits over data x fsdp, n_micro
            assert composed.check_composed(cfg, batch=rows, mm=fn == "plan_mm",
                                           **_kw(mesh)) == got.params, (name, mesh)


def test_fit_table_equals_jax(jax_plans):
    jmp, jcfgs = jax_plans
    meshes = [_kw(m) for m in MESHES[1:5]]
    got = mp.fit_table(LLMConfig.llama3_70b(), meshes, batch=32, seq=2048)
    want = jmp.fit_table(jcfgs["llama3_70b"], meshes, batch=32, seq=2048)
    assert [(m, dataclasses.asdict(p)) for m, p in got] == \
        [(m, dataclasses.asdict(p)) for m, p in want]


def test_plan_trees_have_no_storage():
    """The shapes behind the plan and the check live on the meta device, and
    ``fits`` without a budget reads the card (raises here, without one)."""
    for cfg, mm in ((LLMConfig.llama3_70b(), False), (SliMEConfig.slime_70b(), True)):
        leaves = [t for _, t in named_leaves(composed.abstract_params(cfg, mm))]
        assert leaves and all(t.device.type == "meta" for t in leaves)
    plan = mp.plan(LLMConfig.llama3_8b())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            plan.fits()


@pytest.mark.parametrize("kw", [dict(n_pp=3), dict(batch=30, n_micro=4),
                                dict(n_fsdp=8, batch=12)])
def test_check_composed_raises(kw):
    """Layers the stages do not divide (80 over 3), a batch n_micro does not
    divide, a batch data x fsdp does not divide."""
    args = dict(n_data=1, n_fsdp=1, n_model=1, n_pp=1, batch=32)
    args.update(kw)
    with pytest.raises(ValueError):
        composed.check_composed(LLMConfig.llama3_70b(), **args)
