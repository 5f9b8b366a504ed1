"""P3, the int8 dot probe: its plain version against the JAX script.

``slime_tpu_torch/probes/int8_dot.py`` ports ``pallas_dot`` of
``scripts/bench_int8_dot_probe.py``. The script runs its benchmark when
imported, so its functions are taken from its source with ``ast``: the
XLA reference ``xla_dot`` and ``pallas_dot`` with the three kernel bodies
``_k_nt``, ``_k_nn``, ``_k_nn_bf16``, executed with ``pl.pallas_call`` in
interpret mode at a small shape (M, K, N = 256, 128, 512; 128 x 256 blocks).
The plain version's product is exact and both round int32 to bf16 from
below 2^24, so every form must be equal, bit for bit.
"""
import ast
import functools
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from slime_tpu_torch.ops import w8a8_matmul as w8
from slime_tpu_torch.probes import int8_dot as p3

SCRIPT = Path(__file__).resolve().parent.parent / "scripts" / "bench_int8_dot_probe.py"
M, K, N = 256, 128, 512
BLOCKS = dict(bm=128, bn=256)


@pytest.fixture(scope="module")
def script():
    """The script's xla_dot, _k_* and pallas_dot, bound to the small shape,
    with pallas_call in interpret mode."""
    tree = ast.parse(SCRIPT.read_text())
    names = {"xla_dot", "_k_nt", "_k_nn", "_k_nn_bf16", "pallas_dot"}
    defs = [node for node in tree.body if isinstance(node, ast.FunctionDef) and node.name in names]
    assert {d.name for d in defs} == names
    shim = types.SimpleNamespace(pallas_call=functools.partial(pl.pallas_call, interpret=True),
                                 BlockSpec=pl.BlockSpec, cdiv=pl.cdiv)
    ns = {"jax": jax, "jnp": jnp, "pl": shim, "pltpu": pltpu, "M": M, "K": K, "N": N}
    exec(compile(ast.Module(body=defs, type_ignores=[]), str(SCRIPT), "exec"), ns)
    return ns


@pytest.fixture(scope="module")
def inputs():
    xq, wq, wt = p3.make_inputs("cpu", seed=5, shape=(M, K, N))
    return xq, wq, wt


def _bits(a: np.ndarray) -> np.ndarray:
    """int32 as is; bf16 as its 16 bits."""
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a


def _torch_bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().view(np.uint16) if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("form", list(p3.FORMS))
def test_p3_plain_matches_xla_dot(script, inputs, form):
    """The plain product in each form against the script's ``xla_dot`` (the
    "XLA int8 dot", int32), rounded to bf16 for nn_bf16."""
    xq, wq, wt = inputs
    want = script["xla_dot"](jnp.asarray(xq.numpy()), jnp.asarray(wq.numpy()))
    if form == "nn_bf16":
        want = want.astype(jnp.bfloat16)
    got = p3.plain(form, xq, wq if form == "nt" else wt)
    assert got.dtype == (torch.bfloat16 if form == "nn_bf16" else torch.int32)
    np.testing.assert_array_equal(_torch_bits(got), _bits(np.asarray(want)))


@pytest.mark.parametrize("form", list(p3.FORMS))
def test_p3_plain_matches_script_kernels(script, inputs, form):
    """The plain product against the script's ``pallas_dot`` in the same
    form (its kernel body ``_k_<form>``), run in interpret mode."""
    xq, wq, wt = inputs
    w = wq if form == "nt" else wt
    odt = jnp.bfloat16 if form == "nn_bf16" else jnp.int32
    want = script["pallas_dot"](jnp.asarray(xq.numpy()), jnp.asarray(w.numpy()), form=form,
                                odt=odt, **BLOCKS)
    np.testing.assert_array_equal(_torch_bits(p3.plain(form, xq, w)), _bits(np.asarray(want)))


def test_p3_inputs_are_the_scripts_draw():
    """xq and wq uniform over -127..127 int8 (the script's integers(-127,
    128)), wt the contiguous transpose of wq."""
    xq, wq, wt = p3.make_inputs("cpu", seed=0, shape=(64, 32, 48))
    assert xq.dtype == wq.dtype == torch.int8
    assert xq.shape == (64, 32) and wq.shape == (48, 32) and wt.shape == (32, 48)
    assert wt.is_contiguous() and torch.equal(wt, wq.T)
    assert int(xq.min()) >= -127 and int(xq.max()) <= 127


def test_p3_kernel_needs_a_card():
    """The probe kernel has no CPU mode: CPU tensors raise."""
    xq, wq, _ = p3.make_inputs("cpu", seed=0, shape=(32, 16, 16))
    with pytest.raises(ValueError):
        p3.dot("nt", xq, wq)


@pytest.mark.parametrize("M_,N_,tile_n,sms,want", [(32768, 4096, 128, 132, 132),
                                                   (32768, 4096, 256, 132, 132),
                                                   (100, 200, 128, 132, 2),
                                                   (4616, 1024, 128, 132, 132),
                                                   (1, 1, 128, 132, 1)])
def test_persistent_grid(M_, N_, tile_n, sms, want):
    """One block an SM, or one a 128 x tile_n output tile where fewer."""
    assert w8.persistent_grid(M_, N_, tile_n, sms) == want
