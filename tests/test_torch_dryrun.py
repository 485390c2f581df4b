"""The dry run (``repro_torch.launch.dryrun``) and the model axis it
needs, port against the JAX package, on the CPU.

- ``dist/act.py``: the reference's contract (``tests/test_dist.py``):
  identity outside a context and on a plain tensor, shape and values kept
  inside, rank padding, nesting; on a DTensor of a fake world the
  residual's feature dim sharded over ``model`` (or replicated where the
  mesh does not divide it).
- ``dist/sharding.py``'s builders: every leaf's per-device shape from
  ``param/state/batch/cache_shardings`` of every assigned arch's smoke
  config at (16, 16) and (2, 16, 16) equals the reference builders' (run
  on a stand-in mesh, ``NamedSharding`` swapped for its spec). The port
  holds a decoder's layers one dict a layer where the reference stacks
  them; a leaf whose spec the stacking moves (``sanitize_spec`` puts an
  axis on the stack's layer dim) is itemised in ``STACK_MOVED`` and
  held to the reference's spec less that entry.
- ``roofline/report.py`` against the original on the same rows.
- The port's dry run against the reference's CLI in one subprocess, for
  llama3.2-1b on the 16 x 16 mesh: ``decode_32k``'s argument bytes a
  device, and ``train_4k --no-seq-shard``'s mode, argument bytes,
  collective bytes by kind, and counts itemised: one bucket a leaf of the
  port's per-layer tree for each of the reference's stacked leaves.
- A 2-rank gloo BSP ``asa16`` sharded step and a gspmd ``zero1`` step of
  the smoke llama3.2-1b on the kernels' launch path
  (``test_torch_ranks.dryrun_worker``), counted by ``CostMode``, against
  the dry run at mesh ``data=2``: equal flops, HBM bytes, kernel costs
  and collectives by kind.
- The kernels' meta paths (their costs, no launch) and the production
  meshes' fake world (no CUDA).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import torch  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import get_shape as jget_shape  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.dist import sharding as jsh  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.roofline import report as jreport  # noqa: E402
from repro_torch import kernels as K  # noqa: E402
from repro_torch.configs import get_config as t_get  # noqa: E402
from repro_torch.configs import get_smoke_config as t_smoke  # noqa: E402
from repro_torch.configs import get_shape as tget_shape  # noqa: E402
from repro_torch.configs.base import InputShape  # noqa: E402
from repro_torch.configs.registry import ASSIGNED_ARCHS  # noqa: E402
from repro_torch.core import exchanger as texch  # noqa: E402
from repro_torch.dist import act  # noqa: E402
from repro_torch.dist import sharding as tsh  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.models import build_model as t_build  # noqa: E402
from repro_torch.roofline import report as treport  # noqa: E402
from repro_torch.roofline.analysis import CostMode  # noqa: E402
from test_torch_ranks import (DRY_BATCH, DRY_CASES, DRY_SEQ,  # noqa: E402
                              dry_recipe, dryrun_worker)

HERE = Path(__file__).resolve().parent


class FakeMesh:
    """What the reference's rules read of a mesh: names and sizes."""

    def __init__(self, names, sizes):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, sizes))


MESHES = {"16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16))}


# ---------------------------------------------------------------------------
# act
# ---------------------------------------------------------------------------

def test_act_identity_outside_a_context_and_on_plain_tensors():
    x = torch.ones(2, 8, 16)
    assert act.constrain(x) is x
    with act.activation_spec(None):
        assert act.constrain(x) is x
    with act.activation_spec(P(None, None, "model")):
        assert act.current_spec() == (None, None, "model")
        assert act.constrain(x) is x          # no mesh to place it on
    assert act.current_spec() is None


def test_act_contexts_nest():
    a, b = ("model",), (None, "model")
    with act.activation_spec(a):
        with act.activation_spec(b):
            assert act.current_spec() == b
        assert act.current_spec() == a
    assert act.current_spec() is None


def test_act_rank_pads():
    spec = (None, None, "model")
    assert act.padded_spec(spec, 2) == (None, "model")
    assert act.padded_spec(spec, 4) == (None, None, None, "model")
    assert act.padded_spec(spec, 3) == spec


def test_act_constrain_inside_a_context_shards_the_feature_dim():
    """On a one-device model mesh values and shape are kept (CPU
    tensors); on a 4-device fake world the residual (B, S, 16) keeps its
    shape and each device holds 4 of its 16 features, a 2-D one is
    padded, a feature dim of 6 moves to the sequence (the reference's
    sanitizer), and with nothing divisible it stays replicated."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    with tmesh.fake_world(1):
        mm = tmesh.device_mesh(tsh.Mesh(("model",), (1,)))
        x = torch.arange(2 * 8 * 16, dtype=torch.float32).reshape(2, 8, 16)
        d = DTensor.from_local(x, mm, (Replicate(),))
        with act.activation_spec((None, None, "model")):
            y = act.constrain(d)
        assert y.shape == x.shape and torch.equal(y.to_local(), x)
    with tmesh.fake_world(4):
        mm = tmesh.device_mesh(tsh.Mesh(("model",), (4,)))
        with act.activation_spec((None, None, "model")):
            for shape, want in (((2, 8, 16), Shard(2)), ((8, 16), Shard(1)),
                                ((2, 8, 6), Shard(1)),
                                ((2, 3, 6), Replicate())):
                d = DTensor.from_local(torch.empty(shape, device="meta"), mm,
                                       (Replicate(),), run_check=False)
                y = act.constrain(d)
                assert y.shape == shape and y.placements == (want,)


# ---------------------------------------------------------------------------
# the sharding builders against the reference's
# ---------------------------------------------------------------------------

def _local(shape, spec, mesh):
    out = list(shape)
    for i, e in enumerate(tuple(spec)):
        if e is None:
            continue
        for a in (e if isinstance(e, (tuple, list)) else (e,)):
            out[i] //= mesh.shape[a]
    return tuple(out)


@pytest.fixture
def jax_specs(monkeypatch):
    """The reference's builders return each leaf's spec (no devices)."""
    monkeypatch.setattr(jsh, "NamedSharding", lambda mesh, spec: spec)


def _jax_leaves(tree):
    out = []
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        out.append((tuple(jsh._path_names(path)), leaf))
    return out


# (arch, port leaf path suffix) of the leaves whose reference spec puts an
# axis on the stack's leading layer dim: the port's per-layer leaf has no
# such dim, so the entry drops (it is replicated where the reference
# shards its stack over the layers)
STACK_MOVED: dict = {}


def _compare_params(arch, mesh_name):
    names, sizes = MESHES[mesh_name]
    mesh = FakeMesh(names, sizes)
    tmesh_ = tsh.Mesh(names, sizes)
    jc = j_smoke(arch)
    jparams = jax.eval_shape(j_build(jc).init, jax.random.key(0))
    jspec = jsh.param_shardings(mesh, jparams)
    tparams = tspecs.abstract_params(t_build(t_smoke(arch),
                                                        "meta"))
    tspec = tsh.param_shardings(tmesh_, tparams)
    # the reference's per-device shape of every (stacked) leaf, by its path
    want = {}
    for (path, leaf), (_, s) in zip(_jax_leaves(jparams),
                                    _jax_leaves(jspec)):
        want[path] = (tuple(leaf.shape), _local(leaf.shape, s, mesh),
                      tuple(s))
    moved = []
    for (names_, leaf), s in zip(tsh.named_leaves(tparams),
                                 tsh.spec_leaves(tspec)):
        got = tsh.local_shape(tuple(leaf.shape), s, tmesh_)
        if names_[0] == "layers":
            j = int(names_[1])
            key = _stacked_key(jc, j, names_[2:])
            full, per_dev, js = want[key]
            # the stacked leaf minus its layer dim
            assert full[1:] == tuple(leaf.shape), (names_, full)
            if js and js[0] is not None:
                moved.append(names_[2:])
                js = js[1:]
                per_dev_rest = _local(full[1:], js, mesh)
            else:
                per_dev_rest = per_dev[1:]
            assert got == per_dev_rest, (arch, names_, got, per_dev_rest)
        else:
            full, per_dev, _ = want[tuple(names_)]
            assert full == tuple(leaf.shape) and got == per_dev, names_
    return sorted(set(moved))


def _stacked_key(jc, layer, rest):
    """The reference's path of layer ``layer``'s leaf ``rest``: its
    segment's stack (``blocks``/<segment index>)."""
    from repro.models.transformer import segments
    first = 0
    for si, (_, count) in enumerate(segments(jc)):
        if layer < first + count:
            return ("blocks", str(si)) + tuple(rest)
        first += count
    raise AssertionError(layer)


DECODERS = [a for a in ASSIGNED_ARCHS if a != "seamless-m4t-large-v2"]


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", DECODERS)
def test_param_shardings_match_the_reference(jax_specs, arch, mesh_name):
    moved = _compare_params(arch, mesh_name)
    assert moved == sorted(STACK_MOVED.get((arch, mesh_name), [])), moved


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_encdec_param_shardings_match_the_reference(jax_specs, mesh_name):
    """The encoder-decoder's per-layer lists ``enc``/``dec`` against the
    reference's stacks of the same names."""
    arch = "seamless-m4t-large-v2"
    names, sizes = MESHES[mesh_name]
    mesh, tm = FakeMesh(names, sizes), tsh.Mesh(names, sizes)
    jparams = jax.eval_shape(j_build(j_smoke(arch)).init, jax.random.key(0))
    jspec = jsh.param_shardings(mesh, jparams)
    want = {path: (tuple(leaf.shape), tuple(s)) for (path, leaf), (_, s) in
            zip(_jax_leaves(jparams), _jax_leaves(jspec))}
    tparams = tspecs.abstract_params(t_build(t_smoke(arch),
                                                        "meta"))
    for (nm, leaf), s in zip(tsh.named_leaves(tparams), tsh.spec_leaves(
            tsh.param_shardings(tm, tparams))):
        got = tsh.local_shape(tuple(leaf.shape), s, tm)
        if nm[0] in ("enc", "dec"):
            full, js = want[(nm[0],) + tuple(nm[2:])]
            assert full[1:] == tuple(leaf.shape)
            assert js[:1] in ((), (None,)), (nm, js)
            assert got == _local(full[1:], js[1:], mesh), nm
        else:
            full, js = want[tuple(nm)]
            assert got == _local(full, js, mesh), nm


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_batch_state_and_cache_shardings_match(jax_specs, arch, mesh_name):
    """Batch leaves at every input shape, the (replicated) BSP state, and
    the decode cache of the decode shapes: per-device shapes equal."""
    names, sizes = MESHES[mesh_name]
    mesh, tm = FakeMesh(names, sizes), tsh.Mesh(names, sizes)
    jc, tc = j_smoke(arch), t_smoke(arch)
    for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        js, ts = jget_shape(shape), tget_shape(shape)
        jb = (jspecs.train_batch_specs(jc, js) if js.kind != "decode"
              else jspecs.decode_batch_specs(jc, js))
        tb = (tspecs.train_batch_specs(tc, ts) if ts.kind != "decode"
              else tspecs.decode_batch_specs(tc, ts))
        assert sorted(jb) == sorted(tb)
        jbs = jsh.batch_shardings(mesh, jb)
        tbs = tsh.batch_shardings(tm, tb)
        for n in jb:
            assert tuple(tb[n].shape) == tuple(jb[n].shape)
            assert tsh.local_shape(tuple(tb[n].shape), tbs[n], tm) == \
                _local(jb[n].shape, jbs[n], mesh), (shape, n)
        if ts.kind == "decode":
            # a smoke-sized cache (the spec rule reads only the shapes)
            jcache = jax.eval_shape(lambda: j_build(jc).init_cache(
                ts.global_batch, 64))
            tcache = t_build(tc, "meta").init_cache(
                ts.global_batch, 64)
            jcs = jsh.cache_shardings(mesh, jcache, ts.global_batch)
            tcs = tsh.cache_shardings(tm, tcache, ts.global_batch)
            jl = [(p, leaf, s) for (p, leaf), (_, s) in zip(
                _jax_leaves(jcache), _jax_leaves(jcs))]
            tl = list(zip(tsh.named_leaves(tcache), tsh.spec_leaves(tcs)))
            assert len(jl) == len(tl)
            for (jp, jleaf, jsp), ((tp, tleaf), tsp) in zip(jl, tl):
                assert tuple(jleaf.shape) == tuple(tleaf.shape), (jp, tp)
                assert tsh.local_shape(tuple(tleaf.shape), tsp, tm) == \
                    _local(jleaf.shape, jsp, mesh), (arch, jp)
    state = {"params": tspecs.abstract_params(t_build(tc, "meta")),
             "step": 0}
    assert all(s == () for s in tsh.spec_leaves(tsh.state_shardings(
        tm, state)))


def test_set_replicate_attn_matches_the_reference(jax_specs):
    mesh, tm = FakeMesh(*MESHES["16x16"]), tsh.Mesh(*MESHES["16x16"])
    jparams = jax.eval_shape(j_build(j_smoke("llama3.2-1b")).init,
                             jax.random.key(0))
    tparams = tspecs.abstract_params(t_build(
        t_smoke("llama3.2-1b"), "meta"))
    try:
        jsh.set_replicate_attn(True)
        tsh.set_replicate_attn(True)
        jspec = jsh.param_shardings(mesh, jparams)
        tspec = tsh.param_shardings(tm, tparams)
    finally:
        jsh.set_replicate_attn(False)
        tsh.set_replicate_attn(False)
    jattn = {p[-1]: tuple(s) for p, s in _jax_leaves(jspec)
             if "attn" in p}
    for nm, s in zip((n for n, _ in tsh.named_leaves(tparams)),
                     tsh.spec_leaves(tspec)):
        if "attn" in nm:
            assert s == () and jattn[nm[-1]] == (), nm


# ---------------------------------------------------------------------------
# report.py
# ---------------------------------------------------------------------------

def _rows():
    ok = lambda arch, shape, mesh, mode: {  # noqa: E731
        "arch": arch, "shape": shape, "mesh": mesh, "mode": mode, "ok": True,
        "exchanger": "asa", "compile_s": 3.7,
        "memory": {"argument_bytes": 691478564, "temp_bytes": 1.07e9},
        "collectives": {"counts": {"all-gather": 63, "all-reduce": 81}},
        "roofline": {"t_compute_s": 3.9e-6, "t_memory_s": 6.2e-3,
                     "t_collective_s": 1.9e-2, "dominant": "collective",
                     "useful_ratio": 0.32, "coll_bytes": 8.6e9}}
    return [ok("llama3.2-1b", "decode_32k", "16x16", "decode"),
            ok("llama3.2-1b", "train_4k", "16x16", "bsp"),
            ok("mistral-large-123b", "long_500k", "2x16x16", "decode"),
            {"arch": "mamba2-1.3b", "shape": "prefill_32k", "mesh": "16x16",
             "ok": False, "exchanger": "asa", "error": "RuntimeError: x"}]


def test_report_tables_equal_the_reference(tmp_path):
    rows = _rows()
    for mesh in ("16x16", "2x16x16"):
        assert treport.dryrun_table(rows, mesh) == \
            jreport.dryrun_table(rows, mesh)
        assert treport.roofline_table(rows, mesh) == \
            jreport.roofline_table(rows, mesh)
    for i, r in enumerate(rows):
        (tmp_path / f"{i}.json").write_text(json.dumps(r))
    assert treport.load_results(str(tmp_path)) == \
        jreport.load_results(str(tmp_path))


# ---------------------------------------------------------------------------
# the dry run against the reference's CLI
# ---------------------------------------------------------------------------

_JAX_DRYRUN = r"""
import json, sys
from repro.launch import dryrun as D
out = {}
for shape, seq in (("decode_32k", True), ("train_4k", False)):
    r = D.run_one("llama3.2-1b", shape, False, seq_shard=seq)
    out[shape] = {k: r.get(k) for k in ("ok", "mode", "memory",
                                          "collectives", "error")}
json.dump(out, open(sys.argv[1], "w"))
"""


@pytest.fixture(scope="module")
def jax_dryrun(tmp_path_factory):
    out = tmp_path_factory.mktemp("jdry") / "rows.json"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(HERE.parent / "src"), str(HERE)]), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _JAX_DRYRUN, str(out)],
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(out.read_text())


def test_decode_row_matches_the_reference(jax_dryrun):
    want = jax_dryrun["decode_32k"]
    got = D.run_one("llama3.2-1b", "decode_32k")
    assert want["ok"] and got["ok"], got.get("error")
    assert got["mode"] == want["mode"] == "decode"
    assert got["memory"]["argument_bytes"] == \
        want["memory"]["argument_bytes"] == 691_478_564
    assert not torch.cuda.is_initialized()


def test_bsp_train_row_matches_the_reference(jax_dryrun):
    want = jax_dryrun["train_4k"]
    got = D.run_one("llama3.2-1b", "train_4k", seq_shard=False)
    assert want["ok"] and got["ok"], got.get("error")
    assert got["mode"] == want["mode"] == "bsp"
    assert got["memory"]["argument_bytes"] == \
        want["memory"]["argument_bytes"] == 9_887_039_492
    assert want["collectives"]["counts"] == {"all-to-all": 11,
                                             "all-gather": 11,
                                             "all-reduce": 1}
    # The port buckets one leaf of its per-layer tree where the reference
    # buckets one stacked leaf for all layers: each of the reference's
    # 11 reduce-scatter buckets is the port's buckets of that leaf in
    # every layer, the same bytes in more collectives.
    groups = _stacked_groups(tspecs.abstract_params(
        t_build(t_get("llama3.2-1b"), "meta")))
    big = [g for g in groups if sum(groups[g]) > texch._SMALL_LEAF]
    assert len(big) == 11
    per_leaf = sum(len(groups[g]) for g in big)
    assert per_leaf == 2 + 9 * 16
    assert got["collectives"]["counts"] == {"all-to-all": per_leaf,
                                            "all-gather": per_leaf,
                                            "all-reduce": 1}
    assert got["collectives"]["bytes_by_kind"] == \
        want["collectives"]["bytes_by_kind"]


def _stacked_groups(params) -> dict:
    """The sizes of the port's leaves by the reference's stacked leaf
    they stand for: the path less its layer index."""
    groups: dict = {}
    for path, x in tsh.named_leaves(params):
        key = (path[0],) + path[2:] if path[0] == "layers" else path
        groups.setdefault(key, []).append(x.numel())
    return groups


def test_needs_fsdp_picks_the_references_modes():
    from repro.launch.dryrun import FSDP_THRESHOLD_BYTES as J_THRESHOLD
    assert D.FSDP_THRESHOLD_BYTES == J_THRESHOLD
    from repro.configs import get_config as jget
    from repro.launch.dryrun import needs_fsdp as jneeds
    from repro_torch.configs import get_config as tget
    for multi in (False, True):
        tm = tmesh.make_production_mesh(multi_pod=multi)
        jm = FakeMesh(tm.axis_names, tm.sizes)
        for arch in ASSIGNED_ARCHS:
            assert D.needs_fsdp(tget(arch), tm) == jneeds(jget(arch), jm)


def test_block_kv_is_refused_by_name(capsys):
    with pytest.raises(SystemExit):
        D.main(["--arch", "llama3.2-1b", "--shape", "decode_32k",
                "--block-kv", "512"])
    assert "ROADMAP queue 1 item 5" in capsys.readouterr().err
    row = D.run_one("llama3.2-1b", "decode_32k", block_kv=512)
    assert not row["ok"] and "queue 1 item 5" in row["error"]


def test_cli_writes_one_row_a_mesh_and_the_report_reads_them(tmp_path):
    assert D.main(["--arch", "llama3.2-1b", "--shape", "long_500k",
                   "--mesh", "both", "--out", str(tmp_path)]) == 0
    rows = treport.load_results(str(tmp_path))
    assert sorted(r["mesh"] for r in rows) == ["16x16", "2x16x16"]
    assert all(r["ok"] for r in rows)
    assert "llama3.2-1b | long_500k | decode | ok" in \
        treport.dryrun_table(rows, "2x16x16")
    assert not torch.cuda.is_initialized()


# ---------------------------------------------------------------------------
# the dry run against a counted step on 2 gloo ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def counted_steps(tmp_path_factory):
    from repro_torch.launch.train import run_ranks
    out = tmp_path_factory.mktemp("dryrun_step")
    run_ranks(dryrun_worker, 2, (str(out),))
    return json.loads((out / "dryrun_step.json").read_text())


@pytest.mark.parametrize("case", DRY_CASES)
def test_dry_run_counts_the_step_of_two_ranks(counted_steps, case):
    """Same flops, HBM bytes, kernel costs and collectives by kind: the
    dry run runs the same step code on meta tensors, the kernels' meta
    paths report the launch path's costs, and the fake group takes the
    collectives gloo runs."""
    opt, lr = dry_recipe()
    mesh = tsh.Mesh(("data",), (2,))
    shape = InputShape("dry", DRY_SEQ, 2 * DRY_BATCH, "train")
    with D.mesh_world(mesh):
        prog = D.build_train(t_smoke("llama3.2-1b"), shape, mesh, "asa16",
                             case, optimizer=opt, lr_fn=lr,
                             sharded_update=case == "bsp")
        dry = D.analyze_program(prog, 0.0)
    real = counted_steps[case]
    assert dry["roofline"]["flops"] == real["flops"] > 0
    assert dry["roofline"]["hbm_bytes"] == real["hbm_bytes"]
    assert dry["collectives"]["counts"] == real["counts"]
    assert dry["collectives"]["bytes_by_kind"] == real["bytes_by_kind"]
    assert json.loads(json.dumps(dry["kernels"])) == real["kernels"]
    assert dry["memory"]["temp_bytes"] > 0


# ---------------------------------------------------------------------------
# the kernels' meta paths and the fake world
# ---------------------------------------------------------------------------

def test_meta_paths_report_the_kernels_costs_and_launch_nothing():
    K.reset_launches()
    q = torch.empty(2, 64, 8, 64, device="meta", dtype=torch.bfloat16,
                    requires_grad=True)
    kv = torch.empty(2, 64, 2, 64, device="meta", dtype=torch.bfloat16,
                     requires_grad=True)
    with CostMode() as cm:
        out = fa.flash_attention(q, kv, kv)
        out.sum().backward()
    assert out.is_meta and out.shape == q.shape
    zq = torch.zeros(2, dtype=torch.int32)
    for part, name in (("fwd", "flash_attention"),
                       ("dq", "flash_attention_dq"),
                       ("dkv", "flash_attention_dkv")):
        flops, nbytes = fa.attention_cost(part, 2, 64, 64, 8, 2, 64, 64, zq,
                                          0, 2, part == "fwd")
        assert cm.kernels[name] == {"launches": 1, "flops": flops,
                                    "bytes": nbytes}
    with CostMode() as cm, K.meta_positions(40):
        qd = torch.empty(4, 1, 8, 64, device="meta", dtype=torch.bfloat16)
        cache = torch.empty(4, 128, 2, 64, device="meta",
                            dtype=torch.bfloat16)
        od = fa.flash_decode(qd, cache, cache, 40)
    assert od.shape == qd.shape
    pos = torch.full((4,), 40, dtype=torch.int32)
    assert cm.kernels["flash_decode"]["flops"] == fa.decode_cost(
        pos, 8, 2, 64, 2, 0, 0)[0]
    assert K.LAUNCHES == {}
    with pytest.raises(ValueError, match="meta"):
        pages = torch.empty(8, 16, 2, 64, device="meta",
                            dtype=torch.bfloat16)
        fa.flash_decode_paged(qd, pages, pages,
                              torch.zeros(4, 8, dtype=torch.int32,
                                          device="meta"), 40, page_size=16)


def test_production_meshes_in_a_fake_world_touch_no_card():
    for multi, size in ((False, 256), (True, 512)):
        m = tmesh.make_production_mesh(multi_pod=multi)
        assert np.prod(m.sizes) == size and m.axis_names[-1] == "model"
        with tmesh.fake_world(size):
            dm = tmesh.device_mesh(m)
            assert dm["model"].size() == 16
            g = tmesh.data_group(m)
            assert torch.distributed.get_world_size(g) == size // 16
        assert not torch.distributed.is_initialized()
    assert tmesh.make_host_mesh(8) == tsh.Mesh(("data",), (8,))
    assert tmesh.make_host_mesh(8, ("data", "model")).sizes == (4, 2)
    assert not torch.cuda.is_initialized()
