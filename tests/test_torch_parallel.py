"""The data-parallel helpers, the process-sharded loaders and the sharded
frame cache against the JAX package.

- ``shard_batch``'s divisibility error, ``local_batch_size``,
  ``microbatch_rows`` (the rows JAX's ``(A, B/A)`` reshape of the global
  batch gives each rank), ``initialize_distributed``'s single-process
  warning and its raise on an explicit request that fails.
- The port's ``Loader`` and ``IndexLoader`` with ``process_index`` /
  ``process_count`` yield exactly the JAX loaders' indices, poses and pads,
  on a ragged dataset, shuffled and padded; with ``rows`` each rank gets
  its rows of the JAX processes' concatenated global batch.
- ``FrameRecorder``'s ``lo`` / ``hi`` range and ``as_source`` equal JAX's.
- In 2- and 4-rank gloo groups on the CPU (:mod:`dp_ranks`): each rank's
  ``upload_frames_sharded`` shard, the ``all_gather`` replicated upload,
  and ``make_sharded_gather`` of ``(B,)`` and ``(B, T)`` index batches
  (shard boundaries, the last real frame beside the pad rows) are bit-equal
  to JAX's ``upload_frames_sharded`` / ``make_sharded_gather`` over 2 and 4
  of the conftest's 8 CPU devices, on uint8 frames and on int8 rows;
  ``assert_same_across_processes`` passes on equal values and raises on
  different ones.
- In the same groups, a synced ``BatchNorm2d`` step (the JAX package's
  one-pass variance over every rank's rows) against the port's one-rank
  layer (``F.batch_norm``) on the same global batch, for several seeds of
  a well-conditioned batch: outputs and input gradients within 1e-5 of
  their max-abs, the ranks' summed scale and bias gradients and the
  running statistics within 1e-5 of theirs. (The train-step parity cases
  of tests/test_torch_dp_train.py run a few frames at random init, where
  the one-pass variance is ill-conditioned, and so pin their seed.)
"""

import jax
import numpy as np
import pytest
import torch

from geomapnet_tpu.data import MF as JaxMF
from geomapnet_tpu.data import Loader as JaxLoader
from geomapnet_tpu.data import device_cache as jdc
from geomapnet_tpu.parallel import make_mesh as jax_make_mesh
from geomapnet_tpu_torch.data import device_cache as dc
from geomapnet_tpu_torch.data.composite import MF
from geomapnet_tpu_torch.data.loader import Loader
from geomapnet_tpu_torch.parallel import (
    DataParallel,
    initialize_distributed,
    local_batch_size,
    make_mesh,
    microbatch_rows,
    shard_batch,
)
from dp_ranks import (
    Frames,
    batch_norm_step,
    free_port,
    run_group,
    sync_bn_case,
)

CPU = torch.device("cpu")


class _Posed(Frames):
    """Frames with poses and ``__getitem__`` (a plain frame dataset)."""

    def __init__(self, n, **kw):
        super().__init__(n, **kw)
        self.poses = np.random.RandomState(1).randn(n, 6).astype(np.float32)

    def __getitem__(self, i):
        return self.get_image(i), self.poses[i]


def test_shard_batch_and_local_batch_size():
    mesh = DataParallel(4, 2, CPU)
    x = np.arange(12).reshape(12, 1)
    np.testing.assert_array_equal(shard_batch(x, mesh), x[6:9])
    a, b = shard_batch((x, torch.arange(8)), DataParallel(2, 1, CPU))
    np.testing.assert_array_equal(a, x[6:])
    assert b.tolist() == [4, 5, 6, 7]
    with pytest.raises(ValueError, match="batch dim 10 is not divisible by "
                       "the 4-rank 'data' group; pick a .* multiple of 4"):
        shard_batch(np.zeros((10, 2)), mesh)
    assert local_batch_size(12, mesh) == 3
    assert local_batch_size(12) == 12          # no process group
    with pytest.raises(ValueError, match="not divisible by process count 4"):
        local_batch_size(10, mesh)


@pytest.mark.parametrize("world,batch,accum", [(2, 4, 2), (2, 8, 1),
                                               (4, 16, 2), (2, 12, 3)])
def test_microbatch_rows(world, batch, accum):
    """Every global row once; rank r's chunk k is its part of microbatch k
    (rows [k B/A, (k+1) B/A) of the global batch, split W ways)."""
    rows = [microbatch_rows(r, world, batch, accum) for r in range(world)]
    assert sorted(np.concatenate(rows)) == list(range(batch))
    micro = batch // accum
    for k in range(accum):
        got = np.concatenate([r.reshape(accum, -1)[k] for r in rows])
        np.testing.assert_array_equal(got, np.arange(k * micro,
                                                     (k + 1) * micro))
    if accum == 1:
        for r in range(world):
            np.testing.assert_array_equal(
                rows[r], shard_batch(np.arange(batch), DataParallel(
                    world, r, CPU)))
    with pytest.raises(ValueError, match="not divisible"):
        microbatch_rows(0, world, batch + 1, accum)


def test_initialize_distributed_contract(monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    with pytest.warns(UserWarning, match="continuing single-process"):
        assert initialize_distributed() == (0, 1)
    mesh = make_mesh(CPU)
    assert (mesh.world_size, mesh.rank, mesh.active) == (1, 0, False)
    # an explicit request that cannot form its group raises (rank 1 of 2
    # waits for a coordinator nobody serves)
    with pytest.raises(Exception, match="timed out|refused|connect"):
        initialize_distributed(f"127.0.0.1:{free_port()}", num_processes=2,
                               process_id=1, backend="gloo", timeout_s=1)
    with pytest.raises(ValueError, match="needs coordinator_address"):
        initialize_distributed(num_processes=2)
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (True, False),
                                               (False, False)])
@pytest.mark.parametrize("P", [2, 3])
def test_loader_process_sharding_matches_jax(P, shuffle, drop_last):
    """A ragged 23-sample dataset, batch 4 per process: the same local
    batches (indices through the poses), pads and lengths as JAX's."""
    ds = _Posed(23)
    for p in range(P):
        kw = dict(shuffle=shuffle, drop_last=drop_last, seed=5,
                  process_index=p, process_count=P)
        ours = list(Loader(ds, 4, **kw))
        theirs = list(JaxLoader(ds, 4, **kw))
        assert len(ours) == len(theirs) == len(Loader(ds, 4, **kw)) \
            == len(JaxLoader(ds, 4, **kw))
        for a, b in zip(ours, theirs):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("composite", [False, True])
def test_index_loader_process_sharding_matches_jax(composite):
    ds = _Posed(21)
    mf = (MF(ds, steps=3, skip=2), JaxMF(ds, steps=3, skip=2)) \
        if composite else (ds, ds)
    for p in range(2):
        kw = dict(shuffle=True, drop_last=False, seed=3, process_index=p,
                  process_count=2)
        ours = list(dc.IndexLoader(mf[0], 4, **kw))
        theirs = list(jdc.IndexLoader(mf[1], 4, **kw))
        assert len(ours) == len(theirs) == 3
        for a, b in zip(ours, theirs):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("P,accum", [(2, 2), (4, 2), (2, 4)])
def test_loader_rows_regroup_the_jax_global_batch(P, accum):
    """With ``rows``, rank r's batch b is rows ``microbatch_rows(r)`` of
    the global batch the JAX processes' batches b concatenate to."""
    ds, bs = _Posed(45), 4
    kw = dict(shuffle=True, drop_last=True, seed=9, process_count=P)
    jax_batches = [list(JaxLoader(ds, bs, process_index=p, **kw))
                   for p in range(P)]
    for r in range(P):
        rows = microbatch_rows(r, P, bs * P, accum)
        ours = list(Loader(ds, bs, process_index=r, rows=rows, **kw))
        assert len(ours) == len(jax_batches[0])
        for b, (imgs, poses, pad) in enumerate(ours):
            glob = [np.concatenate([jb[b][i] for jb in jax_batches])
                    for i in range(2)]
            np.testing.assert_array_equal(imgs, glob[0][rows])
            np.testing.assert_array_equal(poses, glob[1][rows])
            assert pad == 0
    with pytest.raises(ValueError, match="drop_last"):
        Loader(ds, bs, process_count=P, rows=rows, drop_last=False)


@pytest.mark.parametrize("lo,hi", [(0, 4), (4, 8), (8, 12)])
def test_recorder_range_and_staged_source_match_jax(lo, hi):
    """A recorder of frames [lo, hi) of 11 (the last range clipped):
    staging, ``seen`` and the staged source over the whole index space
    equal JAX's, a corrupt frame included."""
    src = Frames(11, bad=(5,))
    recorded = []
    for mod in (dc, jdc):
        rec = mod.FrameRecorder(src, lo=lo, hi=hi).install()
        src.get_images([1, 6, 9])
        recorded.append((rec, rec.as_source(num_workers=1)))
    (ours, a), (theirs, b) = recorded
    np.testing.assert_array_equal(ours.staging, theirs.staging)
    np.testing.assert_array_equal(ours.seen, theirs.seen)
    idx = list(range(11))
    for x, y in zip(a.get_images(idx), b.get_images(idx)):
        assert (x is None and y is None) or np.array_equal(x, y)
    assert len(a) == len(b) == 11
    with pytest.raises(ValueError, match="bad record range"):
        dc.FrameRecorder(src, lo=11, hi=12)


FRAMES = {
    "uint8": dict(n=10, shape=(4, 6, 3), dtype=np.uint8),
    "int8_rows": dict(n=10, shape=(2 * 3 * 12,), dtype=np.int8),
}
BATCHES = {
    "flat": np.array([0, 2, 3, 9, 5, 6, 8, 1], np.int32),
    "tuples": np.array([[8, 9, 9], [0, 1, 2], [2, 3, 4], [9, 8, 5],
                        [6, 7, 8], [3, 3, 0], [5, 6, 7], [9, 0, 9]],
                       np.int32),
}


BN_SEEDS = (0, 1, 2, 3, 4)


@pytest.fixture(scope="module", params=[2, 4])
def groups(request):
    world = request.param
    return world, run_group("collectives", world, frames=FRAMES,
                            batches=BATCHES, bn_seeds=BN_SEEDS)


def test_sharded_cache_matches_jax(groups):
    world, ranks = groups
    mesh = jax_make_mesh(jax.devices()[:world])
    gather = jdc.make_sharded_gather(mesh)
    for name, spec in FRAMES.items():
        src = Frames(**spec)
        jbuf = jdc.upload_frames_sharded(src, mesh, num_workers=1)
        full = np.concatenate([r["shards"][name] for r in ranks])
        np.testing.assert_array_equal(full, np.asarray(jbuf))
        per = -(-src.n // world)
        for r, res in enumerate(ranks):
            assert res["range", name] == (r * per, min((r + 1) * per, src.n))
            np.testing.assert_array_equal(res["replicated"][name], src.data)
        for bname, idx in BATCHES.items():
            got = np.concatenate([r["gathered"][name, bname]
                                  for r in ranks])
            want = np.asarray(jax.jit(gather)(jbuf, idx))
            assert got.dtype == want.dtype == spec["dtype"]
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(got, src.data[idx])


def test_group_helpers(groups):
    world, ranks = groups
    for r, res in enumerate(ranks):
        assert res["local_batch"] == 8
        np.testing.assert_array_equal(res["shard_batch"],
                                      np.arange(4 * r, 4 * r + 4))
        assert "rank differ across processes" in res["differ_raised"]


@pytest.mark.parametrize("seed", BN_SEEDS)
def test_sync_batch_norm_matches_one_rank(groups, seed):
    world, ranks = groups
    case = sync_bn_case(seed)
    want = batch_norm_step(*case)
    got = [r["sync_bn"][seed] for r in ranks]
    for k in ("y", "dx"):       # each rank holds its rows
        full = np.concatenate([g[k] for g in got])
        assert np.abs(full - want[k]).max() <= 1e-5 * np.abs(
            want[k]).max(), k
    for k in ("dw", "db"):      # local sums; the step all-reduces them
        total = np.sum([g[k] for g in got], axis=0)
        assert np.abs(total - want[k]).max() <= 1e-5 * np.abs(
            want[k]).max(), k
    for k in ("running_mean", "running_var"):
        for g in got:           # the global statistics on every rank
            assert np.abs(g[k] - want[k]).max() <= 1e-5 * np.abs(
                want[k]).max(), k


def test_upload_refuses_an_oversize_shard():
    mesh = DataParallel(4, 0, CPU)
    with pytest.raises(ValueError, match="per device"):
        dc.upload_frames_sharded(Frames(10), mesh, max_bytes=2 * 72)
    shard = dc.upload_frames_sharded(Frames(10), mesh, max_bytes=3 * 72)
    np.testing.assert_array_equal(shard.numpy(), Frames(10).data[:3])
    with pytest.raises(ValueError, match="shard_frames needs a mesh"):
        dc.upload_dataset_frames(Frames(3), CPU, shard_frames=True)
    with pytest.raises(ValueError, match="not divisible by the 4-rank"):
        dc.make_sharded_gather(mesh)(shard, torch.zeros(6, dtype=torch.int32))


def test_pose_stats_are_written_whole(tmp_path):
    """Every rank of a data-parallel run writes the scene's
    ``pose_stats.txt`` (the same stats) while the others may read it: the
    file holds ``np.savetxt``'s bytes, and a reader racing four writers
    always finds the whole 2x3 table (each write goes through a temporary
    file of its own and a rename). Time-bounded: 2 s of racing."""
    import threading
    import time

    from geomapnet_tpu_torch.data.transforms import write_pose_stats

    path = tmp_path / "assets" / "pose_stats.txt"
    mean, std = np.array([1.5, -2.25, 3.0]), np.array([0.5, 1.0, 2.0])
    write_pose_stats(path, mean, std)
    np.savetxt(tmp_path / "plain.txt", np.vstack((mean, std)), fmt="%8.7f")
    assert path.read_bytes() == (tmp_path / "plain.txt").read_bytes()
    stop, bad = time.monotonic() + 2.0, []

    def writer():
        while time.monotonic() < stop:
            write_pose_stats(path, mean, std)

    def reader():
        while time.monotonic() < stop:
            got = np.loadtxt(path)
            if got.shape != (2, 3):
                bad.append(got.shape)

    threads = [threading.Thread(target=writer) for _ in range(4)]
    threads.append(threading.Thread(target=reader))
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    assert not any(t.is_alive() for t in threads) and not bad
    assert sorted(p.name for p in path.parent.iterdir()) == ["pose_stats.txt"]
