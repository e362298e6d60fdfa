"""The port's sharded wrappers across processes (``parallel/``), on the CPU
with gloo.

Two worlds of two processes each run ``tests/_torch_multiprocess_worker.py``
once: "A", one CPU slot per process, joined through the environment as
``torchrun`` sets it (``initialize()``); "B", two CPU slots per process,
joined by ``initialize(address, world, rank)``, so that local and remote
slots mix on one axis. Each process feeds every wrapper its part of the
global input and writes its part of the output. Here each part is held
against the JAX package's op (Pallas interpret mode, as
``tests/test_torch_parallel.py`` runs it) and the port's single-device op
on the same seeded inputs, the collectives against their single-process
results, and the tp wires' bytes against ``tp_wire_bytes``. Tolerance:
bitwise.
"""
import functools
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

import deepfusion_tpu.ops.packed as J
from deepfusion_tpu.config import ConvConfig as JConvConfig
from deepfusion_tpu.models import FusionNet as JFusionNet
from deepfusion_tpu.models import FusionNetConfig as JFusionNetConfig
from deepfusion_tpu.ops.conv import ConvOp as JConvOp
from deepfusion_tpu.ops.mega import PackedConvPairOp as JPair
from deepfusion_tpu.parallel import make_mesh as jmake_mesh
from deepfusion_tpu.parallel.plan import three_stage_plan as jplan
from deepfusion_tpu_torch.config import ConvConfig
from deepfusion_tpu_torch.ops.packed import (pack_image, pack_image_sharded,
                                             unpack_image,
                                             unpack_image_sharded)
from deepfusion_tpu_torch.parallel import distributed, make_mesh, sp_packed
from deepfusion_tpu_torch.parallel.mesh import Line, Mesh
from deepfusion_tpu_torch.parallel.plan import three_stage_plan
from deepfusion_tpu_torch.parallel.shard import (all_gather, ppermute, psum,
                                                 psum_scatter, sp_conv,
                                                 tp_wire_bytes)
from deepfusion_tpu_torch.utils.logger import CheckError

import _torch_multiprocess_worker as W

torch.set_num_threads(2)
CPU = torch.device("cpu")
WORKER = W.__file__
SLOTS = {"A": 1, "B": 2}
ENV_KEYS = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(world: str, tmp):
    """Run the world's two workers, within 100 s together; (return codes,
    outputs, npz paths)."""
    port = free_port()
    base = {k: v for k, v in os.environ.items() if k not in ENV_KEYS}
    procs, paths = [], []
    for r in range(2):
        paths.append(tmp / f"rank{r}.npz")
        cmd = [sys.executable, WORKER, str(paths[-1]), str(SLOTS[world])]
        env = dict(base)
        if world == "A":
            env.update(WORLD_SIZE="2", RANK=str(r), LOCAL_RANK=str(r),
                       MASTER_ADDR="localhost", MASTER_PORT=str(port))
        else:
            cmd += [str(port), str(r), "2"]
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True,
                                      env=env))
    outs, deadline = [], time.monotonic() + 100
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(deadline - time.monotonic(), 1))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    return [p.returncode for p in procs], outs, paths


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """world -> (return codes, outputs, npz paths), each world run once."""
    runs = {}

    def get(world):
        if world not in runs:
            runs[world] = launch(world, tmp_path_factory.mktemp(world))
        return runs[world]
    return get


def results(worlds, world):
    """The two ranks' npz data of a world whose workers both succeeded."""
    rcs, outs, paths = worlds(world)
    for r, (rc, out) in enumerate(zip(rcs, outs)):
        assert rc == 0, f"world {world} rank {r} failed:\n{out}"
    return [dict(np.load(p)) for p in paths]


def jspec(s):
    return J.PackedSpec(**{f: getattr(s, f) for f in
                           ("h", "w", "c", "cp", "halo", "col_off", "iwp")})


def cpu_mesh(dp=1, sp=1, tp=1):
    return make_mesh(dp, sp, tp, devices=[CPU] * (dp * sp * tp))


@functools.cache
def want(name):
    """{"jax": , "port": } the whole result of a recipe's single op (dense
    NHWC, the logits, or for tp_packed the packed array) in each package."""
    r = W.recipe(name)
    x = r["inputs"]
    if name == "fusionnet":
        jnet = JFusionNet(JFusionNetConfig(**W.SMALL_NET))
        return {"jax": np.asarray(jnet(x[0])),
                "port": W.port_op(name)(torch.from_numpy(x[0])).numpy()}
    if name == "plan":
        p = W.PLAN
        args = (p["mb"], p["hw"], p["ic"], p["oc"], p["oc1"])
        jstep = jplan(jmake_mesh(1, 1, 1), *args,
                      rng=np.random.default_rng(p["seed"]))[0]
        step = three_stage_plan(cpu_mesh(), *args,
                                rng=np.random.default_rng(p["seed"]))[0]
        return {"jax": np.asarray(jstep(x[0])),
                "port": step(torch.from_numpy(x[0])).numpy()}
    op = W.port_op(name)
    if "spec" not in r:
        jop = JConvOp(JConvConfig.make(*r["args"], **r["kw"]), *r["weights"])
        kw = {"sum_src": x[1]} if len(x) > 1 else {}
        tkw = {k: torch.from_numpy(v) for k, v in kw.items()}
        return {"jax": np.asarray(jop(x[0], **kw)),
                "port": op(torch.from_numpy(x[0]), **tkw).numpy()}
    if "a" in r:
        (aa, ak, aw), (ba, bk, bw) = r["a"], r["b"]
        jop = JPair(JConvConfig.make(*aa, **ak), aw[:2],
                    JConvConfig.make(*ba, **bk), bw[:2], sin=jspec(op.sin),
                    **r["op_kw"])
    else:
        jop = J.PackedConvOp(JConvConfig.make(*r["args"], **r["kw"]),
                             *r["weights"], sin=jspec(op.sin), **r["op_kw"])
    jout = np.asarray(jop(J.pack_image(x[0], jspec(op.sin))))
    out = op(pack_image(torch.from_numpy(x[0]), op.sin)).numpy()
    if name == "tp_packed":
        return {"jax": jout, "port": out}
    return {"jax": J.unpack_image(jout, jspec(op.sout_final)),
            "port": unpack_image(torch.from_numpy(out),
                                 op.sout_final).numpy()}


def test_initialize_without_world_size_is_a_noop(monkeypatch):
    for v in (None, "1"):
        if v is None:
            monkeypatch.delenv("WORLD_SIZE", raising=False)
        else:
            monkeypatch.setenv("WORLD_SIZE", v)
        distributed.initialize()
        assert not dist.is_initialized()


def test_initialize_joins_the_group_of_the_environment(monkeypatch):
    """With no arguments and WORLD_SIZE > 1, the group torchrun describes
    (env://); world A joins that way for real."""
    calls = []
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **k: calls.append((a, k)))
    for f, v in (("get_rank", 1), ("get_world_size", 2),
                 ("get_backend", "gloo")):
        monkeypatch.setattr(dist, f, lambda v=v: v)
    distributed.initialize()
    assert calls == [(("gloo",), {"init_method": "env://"})]


def test_local_devices_follow_the_local_rank(monkeypatch):
    assert distributed.local_devices() == (0, [CPU])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert distributed.local_devices() == (0, [torch.device("cuda", 1)])


def test_mesh_refuses_slices_a_process_cannot_run(monkeypatch):
    """A 2 x 2 grid of which process 0 holds three slots, (0, 0), (0, 1)
    and (1, 0), and process 1 one: process 1's dp line crosses process 0's
    slot (0, 1) without process 0's first slot; process 0's dp x sp slots
    are no block; and a line of unequal runs cannot be scattered."""
    monkeypatch.setattr(dist, "new_group", lambda ranks: object())
    devs = np.empty(4, dtype=object)
    devs[:] = [CPU] * 4
    ranks = np.array([0, 0, 0, 1]).reshape(2, 2, 1)
    mesh0 = Mesh(devs.reshape(2, 2, 1), ranks, rank=0)
    mesh1 = Mesh(devs.reshape(2, 2, 1), ranks, rank=1)
    assert mesh0.home("dp") == {"sp": 0, "tp": 0}
    assert mesh0.line("sp", dp=1).group is not None
    with pytest.raises(CheckError, match="first slot lies elsewhere"):
        mesh1.home("dp")
    with pytest.raises(CheckError, match="must form a block"):
        sp_conv(W.port_op("conv_sum"), mesh0, dp_axis="dp")
    line = Line((CPU,) * 3, (0, 0, 1), 0, object(), mesh0)
    assert line.mine == (0, 1)
    with pytest.raises(CheckError, match="equal runs"):
        psum_scatter([torch.zeros(2, 6, dtype=torch.int32)] * 2, line, 1)


@pytest.mark.parametrize("world", ["A", "B"])
def test_workers_ran_without_jax(worlds, world):
    rcs, outs, _ = worlds(world)
    for r, (rc, out) in enumerate(zip(rcs, outs)):
        assert rc == 0, f"world {world} rank {r} failed:\n{out}"
        assert f"MP_OK {r} world=2 slots={SLOTS[world]} no_jax" in out, out


@pytest.mark.parametrize("world", ["A", "B"])
def test_mesh_spans_the_group_rank_major(worlds, world):
    k = SLOTS[world]
    for rank, res in enumerate(results(worlds, world)):
        assert int(res["world"]) == 2 and str(res["backend"]) == "gloo"
        assert res["mesh|ranks"].tolist() == [0] * k + [1] * k
        assert res["mesh|devices"].tolist() == ["cpu"] * 2 * k
        assert res["mesh|mine"].tolist() == list(range(rank * k,
                                                       (rank + 1) * k))


@pytest.mark.parametrize("world", ["A", "B"])
def test_collectives_equal_their_single_process_results(worlds, world):
    """psum, psum_scatter (on the last dim), all_gather and ppermute of
    non-contiguous int32 and uint8 parts: each process's slots hold what
    a single process computes over all the slots."""
    n = 2 * SLOTS[world]
    line = cpu_mesh(tp=n).line("tp")
    for dt in (torch.int32, torch.uint8):
        parts = [W.collective_part(i, dt) for i in range(n)]
        total = sum(p.numpy().astype(np.int64) for p in parts).astype(
            parts[0].numpy().dtype)
        ref = {"psum": psum(parts, line),
               "psum_scatter": psum_scatter(parts, line, 3),
               "all_gather": all_gather(parts, line, 3),
               "ppermute": ppermute(parts, line,
                                    [(i, (i + 1) % n) for i in range(n)])()}
        c = total.shape[3] // n
        for i in range(n):
            np.testing.assert_array_equal(ref["psum"][i].numpy(), total)
            np.testing.assert_array_equal(ref["psum_scatter"][i].numpy(),
                                          total[..., i * c:(i + 1) * c])
            np.testing.assert_array_equal(
                ref["all_gather"][i].numpy(),
                np.concatenate([p.numpy() for p in parts], axis=3))
            assert torch.equal(ref["ppermute"][i], parts[(i - 1) % n])
        for res in results(worlds, world):
            for i in res["mesh|mine"].tolist():
                for k in W.COLLECTIVES:
                    np.testing.assert_array_equal(
                        res[f"coll|{str(dt)[6:]}|{k}|{i}"], ref[k][i].numpy(),
                        err_msg=f"{k} {dt} slot {i}")


@pytest.mark.parametrize("world", ["A", "B"])
@pytest.mark.parametrize("wire", ["psum", "reduce_scatter"])
def test_tp_wire_moves_tp_wire_bytes(worlds, world, wire):
    """Each process's collectives of one tp_fused_conv call move what the
    ring model counts for two processes (A: one slot each, the count
    tp_wire_bytes states; B: two slots each, summed in the process
    first); sp_conv's halo exchange moves one row each way."""
    r = W.recipe("tp_conv")
    cfg = ConvConfig.make(*r["args"], **r["kw"])
    label = f"tp_fused_conv {wire} tp={2 * SLOTS[world]}"
    halo = W.recipe("conv_sum")["inputs"][0]
    for res in results(worlds, world):
        assert int(res[f"{label}|wire"]) == tp_wire_bytes(cfg, 2, wire)
        if world == "A":
            assert int(res["sp_conv sum sp=2|wire"]) == \
                halo[:, :1].nbytes
            assert int(res["dp_shard ConvOp dp=2|wire"]) == 0


def test_pair_shard_shallower_than_its_halo_is_refused(worlds):
    """C7 across processes: a pair of image height 4 over sp=4 leaves
    each shard 1 row below the ph_a + ph_b = 2 its neighbours need."""
    for res in results(worlds, "B"):
        assert "shard height 1 below the halo rows it sends (2)" in \
            str(res["refused"])


CASES = [(w, label, name, kind, shape)
         for w, runs in W.RUNS.items()
         for label, name, kind, shape in runs]


@pytest.mark.parametrize("world,label,name,kind,shape", CASES,
                         ids=[f"{c[0]}: {c[1]}" for c in CASES])
def test_parts_equal_jax_and_the_single_op(worlds, world, label, name, kind,
                                           shape):
    """Each process's part of the output is its block of the JAX op's and
    of the port's single-device op's result; the blocks of the two
    processes cover the whole. sp_packed's parts in the sharded packed
    format (halo bands included) also equal the single-process wrapper's
    on a mesh of the same shape."""
    ref = want(name)
    covered = set()
    for res in results(worlds, world):
        got, meta = res[f"{label}|out"], res[f"{label}|meta"]
        r0, r1, n_dp, c0, c1, n_sp = meta.tolist()
        covered |= {(i, j) for i in range(r0, r1) for j in range(c0, c1)}
        assert got.size > 0
        if name in ("packed", "pair"):
            fn = sp_packed(W.port_op(name), cpu_mesh(*shape),
                           dp_axis="dp" if kind == "sp dp" else None)
            x = pack_image_sharded(
                torch.from_numpy(W.recipe(name)["inputs"][0]),
                fn.local_spec, shape[1])
            np.testing.assert_array_equal(got, W.block_of(fn(x).numpy(),
                                                          meta))
            got = unpack_image_sharded(torch.from_numpy(got),
                                       fn.local_out_spec, c1 - c0).numpy()
        np.testing.assert_array_equal(got, W.block_of(ref["jax"], meta))
        np.testing.assert_array_equal(got, W.block_of(ref["port"], meta))
    assert covered == {(i, j) for i in range(n_dp) for j in range(n_sp)}
