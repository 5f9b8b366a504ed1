"""The port's host data pipeline against the JAX package's (mirrors
``test_data_pipeline.py``, ``test_packing.py``, ``test_preprocess_parity.py``
and ``test_native_preprocess.py``).

- ``preprocess`` for the ``plain``, ``v1``, ``llama3`` and ``mpt``
  templates, with and without an image, legacy and not, with the offline
  HF tokenizer (``tests/fixtures/tiny_hf_tokenizer``) and the toy one: the
  same ids and labels;
- ``SupervisedDataset`` items on a temporary JSON with PNGs (anyres uint8 and
  float32, pad mode, text-only records, two files mixed), the lengths;
- ``LengthGroupedSampler`` indices over seeds; ``data_loader`` and
  ``packed_loader`` batches; ``packing_efficiency``;
- the port's native library (built from its own copy of the C++ source into
  ``slime_tpu_torch/_build/``) against the JAX package's, built here from
  ``native/slime_preprocess.cpp`` with g++ into a temporary directory: the
  crops byte for byte, and both within the JAX tests' bound of the PIL path.

Tolerance: none, every compared array is equal, but the native-vs-PIL bound
(mean |diff| < 0.08 of normalized crops, correlation > 0.995: the resize
kernels round differently).
"""
import json
import os
import shutil
import subprocess

import numpy as np
import pytest
from PIL import Image

from slime_tpu.data import dataset as jds
from slime_tpu.data import native as jnative
from slime_tpu.data import packing as jpack
from slime_tpu.data import preprocess as jpp
from slime_tpu_torch.data import dataset as tds
from slime_tpu_torch.data import image_ops as timage
from slime_tpu_torch.data import native as tnative
from slime_tpu_torch.data import packing as tpack
from slime_tpu_torch.data import preprocess as tpp

from .toy_tokenizer import ToyTokenizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def hf_tok():
    transformers = pytest.importorskip("transformers")
    tok = transformers.AutoTokenizer.from_pretrained(
        os.path.join(REPO, "tests", "fixtures", "tiny_hf_tokenizer"))
    tok.model_max_length = 2048
    return tok


def _convs(i, image):
    q = f"what is in the picture {i} ?" + (" describe this image" if i % 2 else "")
    human = {"from": "human", "value": ("<image>\n" + q) if image else q}
    turns = [human, {"from": "gpt", "value": f"a cat {'red ' * i}."}]
    if i % 3 == 1:
        turns += [{"from": "human", "value": "what color ?"},
                  {"from": "gpt", "value": "blue and green ."}]
    return turns


# the plain template is image-caption pretraining: image records only
@pytest.mark.parametrize("version,has_image", [("plain", True)] + [
    (v, im) for v in ("v1", "llama3", "mpt") for im in (True, False)])
@pytest.mark.parametrize("tok_kind", ["hf", "toy", "toy_legacy"])
def test_preprocess_matches_jax(hf_tok, version, tok_kind, has_image):
    tok = hf_tok if tok_kind == "hf" else ToyTokenizer(legacy=tok_kind == "toy_legacy")
    for i in range(4):
        src = _convs(i, has_image)
        if version == "plain":
            src = src[:2]
        js = jpp.preprocess_multimodal([json.loads(json.dumps(src))]) if has_image else [src]
        ts = tpp.preprocess_multimodal([json.loads(json.dumps(src))]) if has_image else [src]
        assert ts == js
        want = jpp.preprocess(js, tok, has_image=has_image, version=version)
        got = tpp.preprocess(ts, tok, has_image=has_image, version=version)
        for k in ("input_ids", "labels"):
            assert len(got[k]) == len(want[k]) == 1
            np.testing.assert_array_equal(got[k][0], want[k][0], err_msg=f"{k} {i}")
            assert got[k][0].dtype == want[k][0].dtype
    assert tpp.preprocess_multimodal([[{"from": "human", "value": "a <image> b"}]],
                                     mm_use_im_start_end=True) == \
        jpp.preprocess_multimodal([[{"from": "human", "value": "a <image> b"}]],
                                  mm_use_im_start_end=True)
    with pytest.raises(ValueError):
        tpp.preprocess([src], tok, version="nonsense")


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("sft")
    r = np.random.default_rng(0)
    for name, (w, h) in {"a.png": (500, 400), "b.png": (700, 300), "c.png": (336, 900)}.items():
        Image.fromarray(r.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(d / name)
    recs = []
    for i in range(10):
        img = ["a.png", "b.png", "c.png", None][i % 4]
        rec = {"id": str(i), "conversations": _convs(i, img is not None)}
        if img:
            rec["image"] = img
        recs.append(rec)
    (d / "one.json").write_text(json.dumps(recs))
    (d / "two.json").write_text(json.dumps(recs[:3]))
    return d


@pytest.fixture(scope="module")
def jax_native_lib(tmp_path_factory):
    """The JAX package's library built with g++ from native/slime_preprocess.cpp
    into a temporary directory (native/ is left as it is)."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no g++")
    so = str(tmp_path_factory.mktemp("jax_native") / "libslime_preprocess.so")
    subprocess.run([cxx, "-O3", "-std=c++17", "-fPIC", "-shared", "-Wall", "-march=native",
                    "-o", so, os.path.join(REPO, "native", "slime_preprocess.cpp")],
                   check=True, capture_output=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "_SO", so)
        mp.setattr(jnative, "build_native", lambda force=False: True)
        mp.setattr(jnative, "_LIB", None)
        mp.setattr(jnative, "_TRIED", False)
        assert jnative.available()
        yield jnative


def _items_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("aspect,pixel_dtype,tile", [("anyres", "uint8", 336),
                                                     ("anyres", "float32", 336),
                                                     ("anyres", "float32", 56),
                                                     ("pad", "float32", 56)])
def test_supervised_dataset_items_match_jax(jax_native_lib, data_dir, hf_tok, aspect,
                                            pixel_dtype, tile):
    kw = dict(image_folder=str(data_dir), image_aspect_ratio=aspect, conv_version="v1",
              max_crops=8, tile=tile, pixel_dtype=pixel_dtype)
    paths = [str(data_dir / "one.json")]
    t, j = tds.SupervisedDataset(paths, hf_tok, **kw), jds.SupervisedDataset(paths, hf_tok, **kw)
    assert len(t) == len(j) == 10
    assert t.lengths == j.lengths and t.modality_lengths == j.modality_lengths
    assert t.use_native_preprocess == j.use_native_preprocess == (tile == 336)
    for i in range(len(j)):
        _items_equal(t[i], j[i])
    paths = [str(data_dir / "one.json"), str(data_dir / "two.json")]
    t, j = tds.SupervisedDataset(paths, hf_tok, seed=5), jds.SupervisedDataset(paths, hf_tok,
                                                                              seed=5)
    assert t.records == j.records and len(t) == 13


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("group", [True, False])
def test_length_grouped_sampler_matches_jax(seed, group):
    r = np.random.default_rng(seed)
    lengths = [int(x) for x in r.integers(-300, 300, 257)]
    for bs, ws in ((4, 1), (2, 3)):
        t = tds.LengthGroupedSampler(lengths, bs, world_size=ws, seed=seed,
                                     group_by_modality=group)
        j = jds.LengthGroupedSampler(lengths, bs, world_size=ws, seed=seed,
                                     group_by_modality=group)
        for epoch in (0, 2):
            assert t.indices(epoch) == j.indices(epoch)
    one_kind = [abs(x) + 1 for x in lengths]
    assert (tds.LengthGroupedSampler(one_kind, 4, seed=seed).indices()
            == jds.LengthGroupedSampler(one_kind, 4, seed=seed).indices())


@pytest.mark.parametrize("group,workers,drop_last", [(False, 0, True), (True, 2, True),
                                                     (False, 0, False)])
def test_data_loader_batches_match_jax(data_dir, hf_tok, group, workers, drop_last):
    kw = dict(image_folder=str(data_dir), max_crops=8, tile=56, pixel_dtype="uint8")
    t = tds.SupervisedDataset(str(data_dir / "one.json"), hf_tok, **kw)
    j = jds.SupervisedDataset(str(data_dir / "one.json"), hf_tok, **kw)
    lk = dict(batch_size=3, seq_len=40, pad_token_id=hf_tok.pad_token_id, seed=4,
              group_by_modality_length=group, drop_last=drop_last, num_workers=workers)
    got, want = list(tds.data_loader(t, **lk)), list(jds.data_loader(j, **lk))
    assert len(got) == len(want) == (3 if drop_last else 4)
    for g, w in zip(got, want):
        _items_equal(g, w)
    assert list(tds.prefetch(iter(range(5)))) == list(jds.prefetch(iter(range(5))))


@pytest.mark.parametrize("seq_len,bs", [(24, 2), (64, 3)])
def test_packing_matches_jax(hf_tok, seq_len, bs):
    r = np.random.default_rng(seq_len)
    items = [{"input_ids": r.integers(5, 400, n).astype(np.int32),
              "labels": r.integers(-100, 400, n).astype(np.int32)}
             for n in r.integers(3, 40, 23)]
    assert ([[id(x) for x in row] for row in tpack.pack_rows(items, seq_len=seq_len)]
            == [[id(x) for x in row] for row in jpack.pack_rows(items, seq_len=seq_len)])
    kw = dict(batch_size=bs, seq_len=seq_len, pad_token_id=0, buffer_rows=2)
    got, want = list(tpack.packed_loader(iter(items), **kw)), list(
        jpack.packed_loader(iter(items), **kw))
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        _items_equal(g, w)
        assert tpack.packing_efficiency(g) == jpack.packing_efficiency(w)


@pytest.mark.parametrize("h,w", [(500, 700), (1080, 1920), (336, 336), (900, 400)])
@pytest.mark.parametrize("normalize", [True, False])
def test_native_crops_match_jax_library(jax_native_lib, h, w, normalize):
    assert tnative.available()
    assert tnative.build_native().parent == tnative.BUILD_DIR
    img = np.random.default_rng(h * w).integers(0, 255, (h, w, 3), np.uint8)
    tc, tm, tg = tnative.anyres_preprocess_native(img, normalize=normalize)
    jc, jm, jg = jnative.anyres_preprocess_native(img, normalize=normalize)
    assert tg == jg and tc.dtype == jc.dtype
    np.testing.assert_array_equal(tm, jm)
    assert tc.tobytes() == jc.tobytes()
    sq = np.random.default_rng(1).integers(0, 255, (448, 300, 3), np.uint8)
    assert (tnative.square_preprocess_native(sq).tobytes()
            == jnative.square_preprocess_native(sq).tobytes())
    if normalize:
        pil, pm, _ = timage.process_anyres_image_host(Image.fromarray(img))
        np.testing.assert_array_equal(pm, tm)
        n = int(tm.sum())
        diff = np.abs(tc[:n] - pil[:n])
        assert float(diff.mean()) < 0.08, float(diff.mean())
        assert np.corrcoef(tc[:n].ravel(), pil[:n].ravel())[0, 1] > 0.995
        native_route, _, _ = timage.process_anyres_image_host(Image.fromarray(img),
                                                              use_native=True)
        assert native_route.tobytes() == tc.tobytes()


def test_prefetcher_close_releases_its_consumer():
    """A consumer that stops early (a trainer at max_steps) closes its
    prefetcher: the producer thread ends and drops ``map_fn`` and what it
    holds (the port's addition; JAX's producer blocks on its full queue for
    the process's life). ``prefetch``'s generator closes its prefetcher."""
    import gc
    import threading
    import time
    import weakref

    class Held:
        pass
    held = Held()
    ref = weakref.ref(held)
    before = threading.active_count()
    pf = tds.Prefetcher(tds.prefetch(iter(range(100))), depth=2,
                        map_fn=lambda i, h=held: i)
    assert next(pf) == 0
    pf.close()
    del held, pf
    for _ in range(100):
        gc.collect()
        if ref() is None and threading.active_count() <= before:
            break
        time.sleep(0.02)
    assert ref() is None and threading.active_count() <= before
