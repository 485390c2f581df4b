"""The dry run's model axis (``models/tp.py``) on real values, on the CPU.

The dry run costs every program with the ``model`` axis as DTensor on a
fake world, where no value is computed. Here the same code runs on 2
gloo ranks with real fp32 values (``test_torch_ranks.model_axis_worker``):
for each smoke config below, the loss and every gradient under the
reference's placement (``param_shardings``) and three decode steps from an
empty cache (``cache_shardings``) equal the same model on plain tensors,
each rank's shards against the slices of the whole. The configs take
each path of ``models/tp.py``: heads and KV heads sharded; query heads
sharded over a replicated, cut KV head; attention replicated where the
heads do not divide (the out projection gathered); the SSM mixer on its
heads and, where they do not divide, whole; the hybrid layer; expert
parallelism with and without a shared expert; MLA; the encoder-decoder;
the VLM's image prefix; the vocab-parallel embedding in every one.

Tolerance: 1e-5 of the largest |value| (fp32; partial sums over two
ranks add in another order than one sum).
"""
import dataclasses
import json

import pytest

from repro_torch.configs import get_smoke_config
from test_torch_ranks import model_axis_worker

TOL = 1e-5
K = 2


def _fp32(arch, **attn):
    cfg = get_smoke_config(arch).with_overrides(dtype="float32")
    if attn:
        cfg = cfg.with_overrides(attention=dataclasses.replace(
            cfg.attention, **attn))
    return cfg


def _cases():
    mamba = get_smoke_config("mamba2-1.3b")
    return [
        ("llama", _fp32("llama3.2-1b")),
        ("llama-kv1", _fp32("llama3.2-1b", num_kv_heads=1)),
        ("llama-h3", _fp32("llama3.2-1b", num_heads=3, num_kv_heads=1)),
        ("qwen", _fp32("qwen1.5-4b")),
        ("mamba2", _fp32("mamba2-1.3b")),
        # 3 SSM heads: the mixer runs whole on each rank
        ("mamba2-h3", _fp32("mamba2-1.3b").with_overrides(
            d_model=96, ssm=dataclasses.replace(mamba.ssm, head_dim=64))),
        ("hymba", _fp32("hymba-1.5b")),
        ("llama4", _fp32("llama4-scout-17b-a16e")),
        ("deepseek", _fp32("deepseek-v2-lite-16b")),
        ("chameleon", _fp32("chameleon-34b")),
        ("seamless", _fp32("seamless-m4t-large-v2")),
    ]


CASES = [name for name, _ in _cases()]


@pytest.fixture(scope="module")
def axis_runs(tmp_path_factory):
    from repro_torch.launch.train import run_ranks
    out = tmp_path_factory.mktemp("model_axis")
    run_ranks(model_axis_worker, K, (str(out), _cases()))
    return [json.loads((out / f"axis{r}.json").read_text())
            for r in range(K)]


@pytest.mark.parametrize("case", CASES)
def test_model_axis_equals_plain_tensors(axis_runs, case):
    for rank, run in enumerate(axis_runs):
        errs = run[case]
        assert all(v <= TOL for v in errs.values()), (rank, errs)
        assert ("logits" in errs) == (case != "seamless")
