"""The port stands alone: it imports nothing of ``jax`` or ``slime_tpu``, and
its own copies of the JAX package's jax-free modules behave as the
originals.

- A fresh process with an import blocker for ``jax``, ``jaxlib`` and
  ``slime_tpu`` imports every module of ``slime_tpu_torch`` and every module
  ``chip_smoke.py`` names, then ``chip_smoke`` itself; the MoE dispatch,
  MPT and Mamba modules, and ``parallel.mesh``, ``parallel.tensor_parallel``,
  ``ops.moe_ep``, ``parallel.dryrun``, ``parallel.pipeline``,
  ``parallel.composed`` and ``parallel.memory_plan``, are among those it
  walks.
- ``config``: ``SliMEConfig.slime_8b().to_json_dict()`` and every preset,
  field by field, and ``save``/``load`` across the packages.
- ``data.anyres`` grids over a sweep of image sizes, the host anyres crops,
  ``collate``, ``Prefetcher``, ``tokenizer_image_token`` and
  ``StopStringMatcher``.
- ``checkpoint.save_checkpoint``: the files of an adapters-only save and of a
  full save are byte for byte the JAX package's; ``state_ckpt``'s resume
  discovery and the ``PreemptionGuard``.
- The modules the port copies (``serve/grammar``, ``protocol``,
  ``controller``, ``openai_api``, ``tools``, ``gradio_web_server``,
  ``conversation``, ``data/preprocess``, ``data/packing``, ``data/dpo``,
  ``eval/{scorers,sqa_prompt,mmhal,gpt_review,webpage,xlsx}`` and the MMHal
  rubric):
  the originals' code statement for statement, the grammar's tables byte for byte, the
  serving constants; the native preprocess library's C++ source
  (``slime_tpu_torch/native/slime_preprocess.cpp``) byte for byte
  ``native/slime_preprocess.cpp``. The checkpoint
  loader is held leaf for leaf in ``test_torch_checkpoint_load.py``.

Tolerance: none; every compared value and file is equal.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from slime_tpu import checkpoint as jckpt
from slime_tpu import config as jconfig
from slime_tpu.data import anyres as janyres
from slime_tpu.data import dataset as jdataset
from slime_tpu.data import image_ops as jimage
from slime_tpu.data import tokenization as jtok
from slime_tpu.models import slime as jslime
from slime_tpu_torch import checkpoint as tckpt
from slime_tpu_torch import config as tconfig
from slime_tpu_torch import params as bridge
from slime_tpu_torch.data import anyres as tanyres
from slime_tpu_torch.data import dataset as tdataset
from slime_tpu_torch.data import image_ops as timage
from slime_tpu_torch.data import tokenization as ttok

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_and_smoke_import_nothing_of_jax():
    script = textwrap.dedent("""
        import ast, importlib, pkgutil, sys

        class Blocker:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "slime_tpu"):
                    raise ImportError(f"blocked import of {name}")
                return None

        sys.meta_path.insert(0, Blocker())
        import slime_tpu_torch
        mods = [m.name for m in pkgutil.walk_packages(slime_tpu_torch.__path__,
                                                      "slime_tpu_torch.")]
        for m in mods:
            importlib.import_module(m)
        # the MoE dispatch, MPT and Mamba modules, and the mesh, its views,
        # the expert-parallel dispatch, the dry run, the pipeline, the
        # composed steps and the memory plan are among those walked
        assert {"slime_tpu_torch.ops.moe_dispatch", "slime_tpu_torch.models.mpt",
                "slime_tpu_torch.models.mamba", "slime_tpu_torch.parallel.mesh",
                "slime_tpu_torch.parallel.tensor_parallel", "slime_tpu_torch.ops.moe_ep",
                "slime_tpu_torch.parallel.dryrun", "slime_tpu_torch.parallel.pipeline",
                "slime_tpu_torch.parallel.composed",
                "slime_tpu_torch.parallel.memory_plan"} <= set(mods)
        names = set()
        for node in ast.walk(ast.parse(open("chip_smoke.py").read())):
            if isinstance(node, ast.Import):
                names.update(a.name for a in node.names)
            elif isinstance(node, ast.ImportFrom):
                names.update(f"{node.module}.{a.name}" for a in node.names)
        for n in sorted(names):
            try:
                importlib.import_module(n)
            except ModuleNotFoundError:          # a name, not a module
                importlib.import_module(n.rsplit(".", 1)[0])
        import chip_smoke  # noqa: F401
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "slime_tpu"))
        assert not bad, bad
        print(len(mods), "modules OK")
    """)
    env = {k: v for k, v in os.environ.items() if k not in ("SLIME_PLATFORM", "XLA_FLAGS")}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("modules OK")
    assert int(proc.stdout.split()[0]) >= 25


@pytest.mark.parametrize("preset", ["slime_8b", "slime_7b", "slime_13b", "slime_70b",
                                    "tiny"])
def test_slime_config_presets_match(preset):
    t = getattr(tconfig.SliMEConfig, preset)()
    j = getattr(jconfig.SliMEConfig, preset)()
    assert t.to_json_dict() == j.to_json_dict()
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    for prop in ("mm_hidden_size", "hidden_size", "mm_num_heads", "llm_num_heads_128",
                 "has_sampler"):
        assert getattr(t, prop) == getattr(j, prop), prop


@pytest.mark.parametrize("preset", ["llama3_8b", "vicuna_7b", "vicuna_13b", "llama3_70b",
                                    "mistral_7b", "mixtral_8x7b", "tiny"])
def test_llm_config_presets_match(preset):
    t, j = getattr(tconfig.LLMConfig, preset)(), getattr(jconfig.LLMConfig, preset)()
    assert [f.name for f in dataclasses.fields(t)] == [f.name for f in dataclasses.fields(j)]
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(tconfig.VisionConfig()) == dataclasses.asdict(
        jconfig.VisionConfig())


def test_config_save_load_across_packages(tmp_path):
    cfg = dataclasses.replace(tconfig.SliMEConfig.slime_8b(), mm_resampler_topp=0.5)
    cfg.save(str(tmp_path / "t"))
    back = jconfig.SliMEConfig.load(str(tmp_path / "t"))
    assert back.to_json_dict() == cfg.to_json_dict()
    back.save(str(tmp_path / "j"))
    assert tconfig.SliMEConfig.load(str(tmp_path / "j")) == cfg
    assert ((tmp_path / "t" / "config.json").read_bytes()
            == (tmp_path / "j" / "config.json").read_bytes())


SIZES = [(w, h) for w in (90, 336, 500, 672, 1000, 1344, 2016, 3000)
         for h in (60, 336, 448, 672, 1008, 2500)]


def test_anyres_grids_match():
    for size in SIZES:
        w, h = size
        for fn in ("select_best_resolution_uhd", "get_anyres_image_grid_shape"):
            assert getattr(tanyres, fn)(size) == getattr(janyres, fn)(size), (fn, size)
        best = janyres.select_best_resolution_uhd(size)
        assert (tanyres.resize_and_pad_geometry(size, best)
                == janyres.resize_and_pad_geometry(size, best)), size
        for fn in ("compute_slice_grid", "get_patch_nums", "slice_boxes", "area_scale"):
            assert getattr(tanyres, fn)(w, h) == getattr(janyres, fn)(w, h), (fn, size)
        assert tanyres.adapt_size(h, w) == janyres.adapt_size(h, w), size
        cands = [(672, 336), (336, 672), (672, 672), (1008, 336)]
        assert (tanyres.select_best_resolution(size, cands)
                == janyres.select_best_resolution(size, cands)), size


@pytest.mark.parametrize("size", [(640, 480), (300, 900), (1344, 1008)])
@pytest.mark.parametrize("normalize", [True, False])
def test_host_anyres_crops_match(size, normalize):
    r = np.random.default_rng(sum(size))
    img = Image.fromarray(r.integers(0, 255, size[::-1] + (3,), dtype=np.uint8))
    tc, tm, tg = timage.process_anyres_image_host(img, normalize=normalize)
    jc, jm, jg = jimage.process_anyres_image_host(img, normalize=normalize)
    assert tg == jg and tc.dtype == jc.dtype
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(tc, jc)
    chw = r.integers(0, 255, (3, 5, 7)).astype(np.uint8)
    np.testing.assert_array_equal(timage.clip_normalize(chw), jimage.clip_normalize(chw))


def test_collate_matches():
    r = np.random.default_rng(0)
    items = [{"input_ids": r.integers(0, 100, n), "labels": r.integers(-100, 100, n),
              "pixel_values": r.standard_normal((3, 2, 4, 4)).astype(np.float32),
              "crop_mask": np.array([True, n > 5, False])} for n in (3, 9, 12)]
    t = tdataset.collate(items, pad_token_id=7, seq_len=10)
    j = jdataset.collate(items, pad_token_id=7, seq_len=10)
    assert t.keys() == j.keys()
    for k in j:
        assert t[k].dtype == j[k].dtype, k
        np.testing.assert_array_equal(t[k], j[k])


def test_prefetcher_matches():
    for cls in (tdataset.Prefetcher, jdataset.Prefetcher):
        pf = cls(iter(range(7)), depth=3, map_fn=lambda i: i * i)
        assert list(pf) == [i * i for i in range(7)] and pf.batches == 7

    def broken():
        yield 1
        raise RuntimeError("producer failed")
    pf = tdataset.Prefetcher(broken())
    assert next(pf) == 1
    with pytest.raises(RuntimeError, match="producer failed"):
        next(pf)


class _CharTokenizer:
    """Character ids with a BOS (1); 0 is padding."""
    bos_token_id = 1

    def __call__(self, text):
        return type("Enc", (), {"input_ids": [1] + [ord(c) for c in text]})()

    def decode(self, ids, skip_special_tokens=True):
        return "".join(chr(i) for i in ids if i > 1)


@pytest.mark.parametrize("prompt", ["<image>\nWhat is this?", "Look: <image> and <image>.",
                                    "no image here", "<image>"])
def test_tokenizer_image_token_matches(prompt):
    tok = _CharTokenizer()
    for rt in (None, "np"):
        t = ttok.tokenizer_image_token(prompt, tok, return_tensors=rt)
        j = jtok.tokenizer_image_token(prompt, tok, return_tensors=rt)
        np.testing.assert_array_equal(np.asarray(t), np.asarray(j))


def test_stop_string_matcher_matches():
    tok = _CharTokenizer()
    t, j = (m.StopStringMatcher(["</s>", "###"], tok) for m in (ttok, jtok))
    for text in ("hello", "hello###", "a</s>", "</", "#  ###x"):
        ids = [ord(c) for c in text]
        assert t(ids) == j(ids), text
        assert t.trim(text) == j.trim(text), text


def _ckpt_cfg():
    return jconfig.SliMEConfig(
        llm=jconfig.LLMConfig(vocab_size=64, hidden_size=32, intermediate_size=64,
                              num_layers=2, num_heads=2, num_kv_heads=1, head_dim=16,
                              max_position_embeddings=128),
        vision=jconfig.VisionConfig(image_size=56, patch_size=14, hidden_size=32,
                                    intermediate_size=64, num_layers=2, num_heads=2),
        mm_resampler_dim=4, seperator=7, tokenizer_model_max_length=128,
        bos_token_id=1, eos_token_id=2)


@pytest.mark.parametrize("adapters_only", [True, False])
def test_save_checkpoint_files_match(tmp_path, adapters_only):
    jcfg = _ckpt_cfg()
    tcfg = tconfig.SliMEConfig.from_json_dict(jcfg.to_json_dict())
    p = jax.device_get(jslime.init(jax.random.PRNGKey(0), jcfg))
    jckpt.save_checkpoint(str(tmp_path / "jax"), p, jcfg, adapters_only=adapters_only)
    tckpt.save_checkpoint(str(tmp_path / "port"), bridge.from_jax_numpy(p, device="cpu"),
                          tcfg, adapters_only=adapters_only)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    assert ("mm_projector.bin" in names) == adapters_only
    for name in names:
        assert ((tmp_path / "jax" / name).read_bytes()
                == (tmp_path / "port" / name).read_bytes()), name
    if adapters_only:
        sd = torch.load(str(tmp_path / "port" / "mm_projector.bin"))
        assert "model.mm_projector.w_gate" in sd


def test_latest_checkpoint_and_preemption_guard_match(tmp_path):
    from slime_tpu.train import preemption as jpre
    from slime_tpu.train import state_ckpt as jstate
    from slime_tpu_torch.train import preemption as tpre
    from slime_tpu_torch.train import state_ckpt as tstate

    assert tstate.latest_checkpoint(str(tmp_path / "none")) is None
    assert tstate.latest_checkpoint(str(tmp_path)) == jstate.latest_checkpoint(str(tmp_path))
    for d in ("state-3", "state-12", "state-x", "checkpoint-40", "state-7"):
        (tmp_path / d).mkdir()
    assert (tstate.latest_checkpoint(str(tmp_path))
            == jstate.latest_checkpoint(str(tmp_path)) == str(tmp_path / "state-12"))
    for mod in (tpre, jpre):
        with mod.PreemptionGuard() as guard:
            assert not guard.triggered and guard.install_ok()
            guard.trigger()
            assert guard.triggered


def test_prefix_cache_copy_matches():
    """``serve/prefix_cache.py``, the port's own copy: the same content
    digests and slot identities, and the same matches, misses, insertions,
    LRU evictions and stats over one random stream of prompts that share
    prefixes, under a budget that forces eviction."""
    from slime_tpu.serve import prefix_cache as jpc
    from slime_tpu_torch.serve import prefix_cache as tpc

    r = np.random.default_rng(3)
    px = r.standard_normal((3, 3, 8, 8)).astype(np.float32)
    cm = np.array([True, True, False])
    digest = jpc.image_content_digest(px, cm)
    assert tpc.image_content_digest(px, cm) == digest
    assert tpc.image_content_digest(px.astype(np.float16), cm) != digest
    np.testing.assert_array_equal(tpc.image_slot_identities(digest, 50),
                                  jpc.image_slot_identities(digest, 50))
    caches = [m.PrefixCache(block=4, budget_bytes=96) for m in (tpc, jpc)]
    base = r.integers(0, 50, 40)
    for step in range(40):
        ids = base.copy()
        ids[r.integers(4, 40):] = r.integers(0, 50, 1)
        ids = ids[:r.integers(3, 41)]
        got = []
        for pc in caches:
            P, hit = pc.match(ids)
            missing = pc.missing_blocks(ids, len(ids))
            for b, d, parent in missing:
                pc.put(d, parent, {"block": b}, nbytes=8)
            got.append((P, [e["digest"] for e in hit], missing, pc.match_len(ids),
                        sorted(pc.entries), pc.stats()))
        assert got[0] == got[1], step
    assert caches[0].stats()["evicted_blocks"] > 0


OWN_COPIES = ["serve/grammar.py", "serve/protocol.py", "serve/controller.py",
              "serve/openai_api.py", "serve/tools.py", "serve/gradio_web_server.py",
              "conversation.py", "data/preprocess.py", "data/packing.py", "data/dpo.py",
              "eval/scorers.py", "eval/sqa_prompt.py", "eval/mmhal.py", "eval/gpt_review.py",
              "eval/webpage.py", "eval/xlsx.py"]


def _code_dump(path, renames=()):
    """The module's AST without docstrings, with ``renames`` applied to its
    string constants: what the code does, its docstrings aside."""
    import ast

    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            for a, b in renames:
                node.value = node.value.replace(a, b)
    return ast.dump(tree)


@pytest.mark.parametrize("rel", OWN_COPIES)
def test_own_copies_are_the_originals_code(rel):
    """The port's own copies of the JAX package's jax-free serving modules
    are its code statement for statement (docstrings aside; the web UI's
    text names the port's modules)."""
    renames = (("slime_tpu.serve.", "slime_tpu_torch.serve."),)
    assert (_code_dump(os.path.join(REPO, "slime_tpu_torch", rel))
            == _code_dump(os.path.join(REPO, "slime_tpu", rel), renames)), rel


def test_mmhal_rubric_copy_is_the_original():
    """``eval/mmhal.py``'s judging rubric, read beside the module, is byte for
    byte the JAX package's, and both load it as the same template."""
    from slime_tpu.eval import mmhal as jm
    from slime_tpu_torch.eval import mmhal as tm

    with open(os.path.join(REPO, "slime_tpu_torch", "eval", "mmhal_rubric.txt"), "rb") as a, \
            open(os.path.join(REPO, "slime_tpu", "eval", "mmhal_rubric.txt"), "rb") as b:
        assert a.read() == b.read()
    assert tm.JUDGE_TEMPLATE == jm.JUDGE_TEMPLATE


def test_native_source_copy_is_the_original():
    """The port builds the native preprocess library from its own copy of
    the C++ source, byte for byte the JAX package's."""
    with open(os.path.join(REPO, "slime_tpu_torch", "native", "slime_preprocess.cpp"),
              "rb") as a, open(os.path.join(REPO, "native", "slime_preprocess.cpp"), "rb") as b:
        assert a.read() == b.read()


def test_grammar_copy_compiles_the_same_tables():
    """``serve/grammar.py``: byte-equal byte DFAs and token tables over
    ``tests/test_grammar.py``'s patterns, a JSON schema and a choices
    grammar, on a vocabulary of single bytes, multi-byte pieces and an
    empty token."""
    from slime_tpu.serve import grammar as jg
    from slime_tpu_torch.serve import grammar as tg

    from .test_grammar import PATTERNS

    schema = {"type": "object", "properties": {
        "name": {"type": "string"}, "n": {"type": "integer"},
        "tags": {"type": "array", "items": {"enum": ["a", "b"]}, "maxItems": 2}}}
    pats = PATTERNS + [tg.json_schema_regex(schema), tg.choices_regex(["yes", "no", "a.b"]),
                       tg.json_object_regex(3)]
    assert tg.json_schema_regex(schema) == jg.json_schema_regex(schema)
    assert tg.json_object_regex(3) == jg.json_object_regex(3)
    vocab = ([b"</s>", b""] + [bytes([c]) for c in b'abcdefxyz.@ 0123456789_{}":,[]-']
             + [b"ab", b"cd", b"12", b"foo", b"ba", b'":', b"\xc3\xa9"])
    for pat in pats:
        t, j = tg.compile_regex(pat), jg.compile_regex(pat)
        np.testing.assert_array_equal(t.trans, j.trans)
        np.testing.assert_array_equal(t.accept, j.accept)
        t, j = tg.compile_token_dfa(pat, vocab, eos_id=0), jg.compile_token_dfa(pat, vocab,
                                                                                 eos_id=0)
        for name in ("allowed", "nxt", "accept"):
            a, b = getattr(t, name), getattr(j, name)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), (pat, name)


def test_serving_constants_match():
    from slime_tpu import constants as jc
    from slime_tpu_torch import constants as tc
    for name in ("CONTROLLER_HEART_BEAT_EXPIRATION", "WORKER_HEART_BEAT_INTERVAL", "LOGDIR",
                 "DEFAULT_IMAGE_TOKEN"):
        assert getattr(tc, name) == getattr(jc, name), name
    for path in ("a/b/model-x", "a/llava-13b/checkpoint-200/", "m"):
        assert ttok.get_model_name_from_path(path) == jtok.get_model_name_from_path(path)
