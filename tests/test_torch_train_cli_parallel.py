"""The training command line under a 2-rank launch (``--mesh-fsdp 2``).

Each rank runs ``slime_tpu_torch.train.cli.main`` in its own process with
torchrun's environment (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``) set by the test, ``--device cpu`` (gloo)
and ``--per-device-batch-size 1``: the loader yields the global batch of 2,
each rank trains on its row. A one-process run with ``--per-device-batch-size
2`` sees the same global batches. Two full-parameter steps (constant LR, no
warmup) on text-only records; rank 0 writes the checkpoint (the files of the
one-process run). The CLI computes in bf16, whose sums the two runs take in
another order, and Adam's first steps have the size of the learning rate
whatever the gradient's, so an entry with a near-zero gradient may move by
a different amount: the check is that each step's logged loss agrees to
1e-3 and that the two trained trees differ by under 2% of the distance
either moved from the starting weights (leaf by leaf, for every leaf that
moved).

The toy tokenizer grows its vocabulary as it meets words and the loader
tokenizes in threads, so each process first walks the dataset in order.
"""
import json
import os

import numpy as np
import pytest
import torch

from .torch_ranks import start_ranks


def _argv(model, data_json, out, per_device, *extra):
    return ["--model-path", model, "--data-path", data_json, "--image-folder", "",
            "--output-dir", out, "--version", "v1", "--per-device-batch-size", str(per_device),
            "--model-max-length", "64", "--logging-steps", "1", "--learning-rate", "1e-3",
            "--max-steps", "2", "--save-steps", "0", "--lr-scheduler-type", "constant",
            "--warmup-ratio", "0", "--device", "cpu", *extra]


def _warm_and_run(argv):
    from slime_tpu_torch.config import SliMEConfig
    from slime_tpu_torch.train import cli

    from .toy_tokenizer import ToyTokenizer
    tok = ToyTokenizer()
    args = cli.parse_args(argv)
    ds = cli.build_dataset(args, SliMEConfig.load(args.model_path), tok)
    for i in range(len(ds)):
        ds[i]
    return cli.main(argv, tokenizer=tok)


def _worker(argv):
    rank, world, address, where = int(argv[0]), int(argv[1]), argv[2], argv[3]
    host, port = address.removeprefix("tcp://").rsplit(":", 1)
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank),
                      MASTER_ADDR=host, MASTER_PORT=port)
    torch.set_num_threads(1)
    inp = torch.load(os.path.join(where, "inputs.pt"))
    tr = _warm_and_run(_argv(*inp["paths"], 1, "--mesh-fsdp", "2"))
    import torch.distributed as dist
    tree = tr.params_host()                    # a collective: every rank calls it
    torch.save({"main": tr.main, "mesh": dict(tr.mesh.shape), "params": tree},
               os.path.join(where, f"rank{rank}.pt"))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from slime_tpu_torch.config import LLMConfig, SliMEConfig, VisionConfig
    d = tmp_path_factory.mktemp("cli_parallel")
    cfg = SliMEConfig(
        llm=LLMConfig(vocab_size=512, hidden_size=128, intermediate_size=256, num_layers=2,
                      num_heads=4, num_kv_heads=2, head_dim=32, max_position_embeddings=256),
        vision=VisionConfig(image_size=56, patch_size=14, hidden_size=32,
                            intermediate_size=64, num_layers=2, num_heads=2),
        mm_resampler_dim=4, seperator=7, tokenizer_model_max_length=64, bos_token_id=1,
        eos_token_id=2, max_local_crops=1)
    cfg.save(str(d / "model"))
    txt = [{"id": str(i), "conversations": [
        {"from": "human", "value": f"question {i} what color ?"},
        {"from": "gpt", "value": "blue " * (i % 5 + 1) + "."}]} for i in range(8)]
    (d / "txt.json").write_text(json.dumps(txt))
    return str(d / "model"), str(d / "txt.json"), d


def test_two_rank_launch_trains_the_one_process_model(setup, tmp_path):
    from slime_tpu_torch.config import SliMEConfig
    from slime_tpu_torch.params import named_leaves
    from slime_tpu_torch.train import cli
    model, data, d = setup
    ranks = start_ranks("test_torch_train_cli_parallel", 2,
                        {"paths": (model, data, str(d / "two"))}, tmp_path)
    try:                                # the one-process run beside the ranks
        argv = _argv(model, data, str(d / "one"), 2)
        start = dict(named_leaves(cli.build_params(cli.parse_args(argv),
                                                   SliMEConfig.load(model),
                                                   torch.device("cpu"))))
        one = _warm_and_run(argv)
    except BaseException:
        ranks.kill()
        raise
    outs = ranks.wait()
    assert one.mesh is None and one.state["step"] == 2
    assert [o["main"] for o in outs] == [True, False]
    assert outs[0]["mesh"] == {"data": 1, "fsdp": 2, "model": 1}
    assert sorted(os.listdir(d / "two")) == sorted(os.listdir(d / "one"))
    recs = [json.loads(x) for x in open(d / "two" / "metrics.jsonl")]
    want_recs = [json.loads(x) for x in open(d / "one" / "metrics.jsonl")]
    assert [r["step"] for r in recs] == [1, 2]
    np.testing.assert_allclose([r["loss"] for r in recs], [r["loss"] for r in want_recs],
                               rtol=1e-3)
    want = dict(named_leaves(one.params_host()))
    moved = 0
    for path, got in named_leaves(outs[0]["params"]):
        step = (want[path] - start[path]).float().norm()
        if step == 0:
            assert torch.equal(got, want[path]), path
            continue
        assert (got - want[path]).float().norm() < 0.02 * step, path
        moved += 1
    assert moved > 10
