"""The mesh substrate: boxing collectives over ranks, GlobalTensor and SUMMA.

Holds ``repro_torch.core`` (mesh, boxing, global_tensor, summa) to the JAX
package on the same seeded numpy data. The JAX side needs several host
devices, and jax fixes its device count when its backend starts, so it runs
once per module in a subprocess (``XLA_FLAGS=
--xla_force_host_platform_device_count=8``) from the code below, writing
its results to ``tmp_path`` as ``.npz``; the port runs in process on the
CPU, every rank a thread.

* boxing: every single-axis pair of S(0), S(1), B and P(sum) on meshes (2,),
  (4,), (2, 2) and (2, 4), and 2-D transitions where two mesh axes split one
  tensor axis (release and impose phases), on integer-valued float32 data so
  every sum is exact: each rank's shard bitwise the JAX one, and the logical
  value kept (``assemble``). Where an earlier mesh axis changes and a later
  one keeps a split of the same tensor axis (e.g. ``(S(0), S(0)) -> (B,
  S(0))``), the reference scrambles the blocks; the port does not, and the
  test pins that set of cases;
* GlobalTensor: the Table 4 program of ``examples/quickstart.py`` and a
  partial-value product, ``rtol=1e-6``;
* ``summa_matmul`` against the JAX one and against ``x @ w``, ``rtol=1e-6``;
* the port alone: two runs are bitwise equal, a rank that skips a
  collective makes every rank raise within the timeout, broadcast shards
  never share storage, and collectives stay exact under thread churn.
"""
import itertools
import json
import os
import pathlib
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.core import mesh as M
from repro_torch.core.boxing import boxing_fn
from repro_torch.core.global_tensor import (GlobalTensor, matmul,
                                            reduce_partial)
from repro_torch.core.mesh import (CollectiveError, assemble, place,
                                   shard_slices, spmd)
from repro_torch.core.placement import Placement
from repro_torch.core.sbp import Split, ndsbp
from repro_torch.core.summa import summa_matmul

SRC = str(pathlib.Path(__file__).resolve().parents[1] / "src")
SHAPE = (8, 16)
MESHES = [(("a",), (2,)), (("a",), (4,)), (("a", "b"), (2, 2)),
          (("a", "b"), (2, 4))]
COMPS = ["S(0)", "S(1)", "B", "P"]
TWO_D = [("S(0),S(0)", "B,B"), ("S(0),B", "B,S(0)"), ("B,B", "S(0),S(0)"),
         ("S(0),S(0)", "S(1),S(1)"), ("P,P", "S(0),S(0)"),
         ("S(0),S(1)", "S(1),S(0)"), ("S(0),S(0)", "S(0),B"),
         ("S(0),P", "S(0),S(0)")]


def _cases():
    out = []
    for names, sizes in MESHES:
        if len(sizes) == 1:
            pairs = [(a, b) for a in COMPS for b in COMPS]
        else:
            pairs = [(",".join(src), ",".join(dst))
                     for k in range(2) for other in ("S(0)", "B")
                     for a in COMPS for b in COMPS if a != b
                     for src, dst in [([a, other] if k == 0 else [other, a],
                                       [b, other] if k == 0 else [other, b])]]
            pairs += TWO_D
        out += [dict(names=names, sizes=sizes, src=s, dst=d)
                for s, d in pairs]
    return out


def _mesh(names, sizes):
    return Placement(tuple(names), tuple(sizes)).to_mesh("cpu")


def _local_inputs(case, x, rng):
    """Each rank's shard of ``x`` under ``src``: P(sum) axes hold integer
    parts summing over their group to the value."""
    mesh = _mesh(case["names"], case["sizes"])
    src = ndsbp(case["src"])
    shards = [s.numpy() for s in place(torch.from_numpy(x), mesh, src)]
    for k, comp in enumerate(src):
        if not comp.is_partial:
            continue
        noise = {}
        for r in range(mesh.size):
            c = mesh.coords(r)
            if c[k] != 0:
                noise[r] = rng.integers(-3, 4, shards[r].shape).astype(
                    np.float32)
        for r, v in noise.items():
            shards[r] = shards[r] + v
            c = list(mesh.coords(r))
            c[k] = 0
            r0 = mesh.rank_of(c)
            shards[r0] = shards[r0] - v
    return np.stack(shards)


JAX_CODE = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, sys.argv[1])
out_dir = sys.argv[2]
import numpy as np
import jax
from jax.sharding import PartitionSpec as PS
from repro.compat import shard_map
from repro.core.boxing import boxing_fn
from repro.core.global_tensor import GlobalTensor, matmul, reduce_partial
from repro.core.placement import Placement
from repro.core.sbp import ndsbp
from repro.core.summa import summa_matmul

cases = json.load(open(os.path.join(out_dir, "cases.json")))
inputs = np.load(os.path.join(out_dir, "inputs.npz"))
res = {}
for i, c in enumerate(cases):
    names, sizes = tuple(c["names"]), tuple(c["sizes"])
    mesh = Placement(names, sizes, device_kind="cpu").to_mesh()
    fn = boxing_fn(ndsbp(c["src"]), ndsbp(c["dst"]), names, sizes,
                   tuple(c["shape"]))
    f = shard_map(lambda x, fn=fn: fn(x[0])[None], mesh=mesh,
                  in_specs=(PS(names),), out_specs=PS(names), check=False)
    res[f"box{i}"] = np.asarray(jax.jit(f)(inputs[f"in{i}"]))

# Table 4 (examples/quickstart.py) and a partial-value product
placement = Placement(("data", "model"), (2, 4), device_kind="cpu")
mesh = placement.to_mesh()
rng = np.random.default_rng(0)
A0 = GlobalTensor.from_global(rng.normal(size=(4, 8)).astype(np.float32),
                              placement, "S(0),B", mesh)
B0 = GlobalTensor.from_global(rng.normal(size=(8, 8)).astype(np.float32),
                              placement, "B,B", mesh)
Y0 = matmul(A0, B0)
Y0b = Y0.to_global("B,B")
B1 = GlobalTensor.from_global(rng.normal(size=(8, 8)).astype(np.float32),
                              placement, "B,S(1)", mesh)
Y1 = matmul(Y0b, B1)
res["Y0"], res["Y0b"], res["Y1"] = Y0.numpy(), Y0b.numpy(), Y1.numpy()
X2 = GlobalTensor.from_global(rng.normal(size=(4, 8)).astype(np.float32),
                              placement, "S(0),S(1)", mesh)
W2 = GlobalTensor.from_global(rng.normal(size=(8, 8)).astype(np.float32),
                              placement, "B,S(0)", mesh)
Y2 = matmul(X2, W2)
res["Y2"] = reduce_partial(Y2).numpy()
res["sbp"] = np.array([str(t.sbp) for t in (Y0, Y0b, Y1, Y2)])

# SUMMA on a (2, 2) mesh
mesh = Placement(("r", "c"), (2, 2), device_kind="cpu").to_mesh()
x, w = inputs["summa_x"], inputs["summa_w"]
f = shard_map(lambda a, b: summa_matmul(a, b, row_axis="r", col_axis="c",
                                        n_row=2, n_col=2),
              mesh=mesh, in_specs=(PS("r", "c"), PS("r", "c")),
              out_specs=PS("r", "c"), check=False)
res["summa"] = np.asarray(jax.jit(f)(x, w))
np.savez(os.path.join(out_dir, "jax.npz"), **res)
print("JAX-OK")
"""


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The cases, their inputs, and the JAX package's results, computed
    once in a subprocess with 8 host devices."""
    out = tmp_path_factory.mktemp("jax_mesh")
    rng = np.random.default_rng(0)
    cases = _cases()
    x = rng.integers(-8, 9, SHAPE).astype(np.float32)
    inputs = {}
    for i, c in enumerate(cases):
        c["shape"] = list(SHAPE)
        inputs[f"in{i}"] = _local_inputs(c, x, rng)
    inputs["summa_x"] = rng.normal(size=(8, 8)).astype(np.float32)
    inputs["summa_w"] = rng.normal(size=(8, 8)).astype(np.float32)
    (out / "cases.json").write_text(json.dumps(cases))
    np.savez(out / "inputs.npz", **inputs)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", JAX_CODE, SRC, str(out)],
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0 and "JAX-OK" in proc.stdout, (
        proc.stdout[-3000:] + proc.stderr[-3000:])
    return cases, x, inputs, dict(np.load(out / "jax.npz"))


def _reference_scrambles(src: str, dst: str) -> bool:
    """Where the reference's boxing_fn keeps a bystander split that an
    earlier changing mesh axis shares a tensor axis with."""
    src, dst = ndsbp(src), ndsbp(dst)

    def ax(c):
        return c.axis if isinstance(c, Split) else None
    changing = [k for k in range(len(src)) if src[k] != dst[k]]
    return any(src[j] == dst[j] and ax(src[j]) is not None and any(
        k < j and ax(src[j]) in (ax(src[k]), ax(dst[k])) for k in changing)
        for j in range(len(src)))


def test_boxing_matches_jax_bitwise_and_keeps_the_value(jax_side):
    cases, x, inputs, jx = jax_side
    scrambled = []
    for i, c in enumerate(cases):
        mesh = _mesh(c["names"], c["sizes"])
        fn = boxing_fn(c["src"], c["dst"], tuple(c["names"]),
                       tuple(c["sizes"]), SHAPE)
        got = spmd(fn, mesh)([torch.from_numpy(v)
                              for v in inputs[f"in{i}"]])
        what = f"{c['sizes']} {c['src']} -> {c['dst']}"
        logical = assemble(got, mesh, c["dst"])
        assert torch.equal(logical, torch.from_numpy(x)), what
        want = jx[f"box{i}"]
        jax_logical = assemble([torch.from_numpy(v) for v in want], mesh,
                               c["dst"])
        if not torch.equal(jax_logical, torch.from_numpy(x)):
            scrambled.append((tuple(c["sizes"]), c["src"], c["dst"]))
            continue
        for r, (a, b) in enumerate(zip(got, want)):
            assert a.shape == b.shape and np.array_equal(a.numpy(), b), (
                f"{what}: rank {r}")
    assert scrambled == [
        (tuple(c["sizes"]), c["src"], c["dst"]) for c in cases
        if _reference_scrambles(c["src"], c["dst"])]
    assert ((2, 2), "S(0),S(0)", "B,S(0)") in scrambled


def test_place_and_assemble_follow_the_shard_layout():
    mesh = _mesh(("a", "b"), (2, 4))
    x = torch.arange(128.0).reshape(SHAPE)
    for sig in ("S(0),S(0)", "S(0),S(1)", "S(1),S(0)", "B,S(1)", "P,S(0)"):
        shards = place(x, mesh, sig)
        assert torch.equal(assemble(shards, mesh, sig), x)
        for r, s in enumerate(shards):
            if "P" not in sig or mesh.coords(r)[0] == 0:
                sl = shard_slices(SHAPE, ndsbp(sig), mesh.shape,
                                  mesh.coords(r))
                assert torch.equal(s, x[sl]), (sig, r)
    # two mesh axes on one tensor axis: the earlier mesh axis is major
    assert shard_slices((8, 2), ndsbp("S(0),S(0)"), (2, 4),
                        (1, 2))[0] == slice(6, 7)


def test_global_tensor_table4_matches_jax(jax_side):
    *_, jx = jax_side
    placement = Placement(("data", "model"), (2, 4))
    mesh = placement.to_mesh("cpu")
    rng = np.random.default_rng(0)

    def gt(shape, sbp):
        return GlobalTensor.from_global(
            rng.normal(size=shape).astype(np.float32), placement, sbp, mesh)
    A0, B0 = gt((4, 8), "S(0),B"), gt((8, 8), "B,B")
    Y0 = matmul(A0, B0)
    Y0b = Y0.to_global("B,B")
    Y1 = matmul(Y0b, gt((8, 8), "B,S(1)"))
    X2, W2 = gt((4, 8), "S(0),S(1)"), gt((8, 8), "B,S(0)")
    Y2 = matmul(X2, W2)
    assert [str(t.sbp) for t in (Y0, Y0b, Y1, Y2)] == list(jx["sbp"])
    for name, t in (("Y0", Y0), ("Y0b", Y0b), ("Y1", Y1),
                    ("Y2", reduce_partial(Y2))):
        np.testing.assert_allclose(t.numpy(), jx[name], rtol=1e-6,
                                   atol=1e-6, err_msg=name)
    np.testing.assert_allclose(Y2.numpy(), jx["Y2"], rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="partial"):
        Y0.to_global("P,B")


def test_summa_matches_jax_and_the_product(jax_side):
    _, _, inputs, jx = jax_side
    x, w = inputs["summa_x"], inputs["summa_w"]
    mesh = Placement(("r", "c"), (2, 2)).to_mesh("cpu")
    lay = ndsbp("S(0),S(1)")
    run = spmd(lambda a, b: summa_matmul(a, b, row_axis="r", col_axis="c",
                                         n_row=2, n_col=2), mesh,
               in_layouts=(lay, lay), out_layouts=lay)
    y = run(x, w)
    np.testing.assert_allclose(y.numpy(), jx["summa"], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(y.numpy(), x @ w, rtol=1e-5, atol=1e-5)
    assert torch.equal(y, run(x, w))          # bitwise repeatable


# ---------------------------------------------------------------------------
# The port alone.
# ---------------------------------------------------------------------------

def test_two_runs_are_bitwise_equal():
    mesh = _mesh(("a", "b"), (2, 4))
    rng = np.random.default_rng(3)
    parts = [torch.from_numpy(rng.normal(size=SHAPE).astype(np.float32))
             for _ in range(mesh.size)]
    fn = boxing_fn("P,P", "S(1),B", ("a", "b"), (2, 4), SHAPE)
    a, b = spmd(fn, mesh)(parts), spmd(fn, mesh)(parts)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    # a reduction in rank order: every rank of a group has the same bits
    s = spmd(lambda v: M.psum(v, ("a", "b")), mesh)(parts)
    want = parts[0]
    for p in parts[1:]:
        want = want + p
    assert all(torch.equal(v, want) for v in s)


@pytest.mark.parametrize("fault", ["returns", "late", "other_collective"])
def test_a_skipped_collective_raises_on_every_rank(fault):
    timeout = 0.5
    mesh = Placement(("d",), (4,)).to_mesh("cpu", timeout=timeout)

    def body(x):
        r = M.current_rank()
        if r == 1 and fault == "returns":
            return x
        if r == 1 and fault == "late":
            time.sleep(3 * timeout)
        if r == 1 and fault == "other_collective":
            return M.all_gather(x, "d")
        return M.psum(x, "d")

    t0 = time.perf_counter()
    with pytest.raises(CollectiveError) as err:
        spmd(body, mesh)([torch.ones(2) for _ in range(4)])
    elapsed = time.perf_counter() - t0
    ranks = set(err.value.rank_errors)
    if fault == "returns":
        assert ranks == {0, 2, 3}           # rank 1 returned without it
        assert "returned without joining" in str(err.value)
        assert elapsed < timeout
    else:
        assert ranks == {0, 1, 2, 3}
        assert all(isinstance(e, CollectiveError)
                   for e in err.value.rank_errors.values())
        assert elapsed < 3 * timeout + 2.0
    if fault == "late":
        assert "timed out after 0.5 s" in str(err.value)
        assert "over 'd'" in str(err.value)


def test_broadcast_shards_never_share_storage():
    mesh = _mesh(("a", "b"), (2, 2))
    x = torch.arange(128.0).reshape(SHAPE)

    def storages(ts):
        return {t.untyped_storage().data_ptr() for t in ts}
    for shards in (place(x, mesh, "B,B"), place(x, mesh, "S(0),B"),
                   spmd(lambda v: M.psum(v, "a"), mesh)(place(x, mesh, "P,B")),
                   spmd(lambda v: M.all_gather(v, ("a", "b")), mesh)(
                       place(x, mesh, "S(0),S(0)")),
                   spmd(boxing_fn("P,P", "B,B", ("a", "b"), (2, 2), SHAPE),
                        mesh)(place(x, mesh, "P,P"))):
        assert len(storages(shards)) == mesh.size
    shards = place(x, mesh, "B,B")
    shards[1].add_(1.0)                 # an in-place update on one replica
    assert torch.equal(shards[0], x) and torch.equal(shards[2], x)


def test_collectives_stay_exact_under_thread_churn():
    """Eight ranks on few cores, a tiny switch interval: every result and
    the stats counters are exact, so no rendezvous lost an update."""
    mesh = Placement(("a", "b"), (2, 4)).to_mesh("cpu", timeout=30.0)
    rounds = 100
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def body(x):
            out = []
            for i in range(rounds):
                out.append(M.psum(x + i, "b"))
                out.append(M.all_gather(x, "a"))
            return out
        t0 = time.perf_counter()
        res = spmd(body, mesh)([torch.full((3,), float(r))
                                for r in range(8)])
        assert time.perf_counter() - t0 < 60
    finally:
        sys.setswitchinterval(old)
    for r in range(8):
        a, b = mesh.coords(r)
        group = [mesh.rank_of((a, j)) for j in range(4)]
        for i in range(rounds):
            assert torch.equal(res[r][2 * i], torch.full(
                (3,), float(sum(group) + 4 * i)))
            assert torch.equal(res[r][2 * i + 1], torch.tensor(
                [float(mesh.rank_of((k, b))) for k in range(2)
                 for _ in range(3)]))
    assert mesh.stats.calls == {"psum": 2 * rounds, "all_gather": 4 * rounds}
    assert threading.active_count() < 50


def test_spmd_carries_grad_mode_and_places_by_layout():
    mesh = _mesh(("d",), (4,))
    with torch.no_grad():
        modes = spmd(lambda: torch.is_grad_enabled(), mesh)()
    assert modes == [False] * 4
    with torch.inference_mode():
        inf = spmd(lambda: torch.is_inference_mode_enabled(), mesh)()
    assert inf == [True] * 4
    x = torch.arange(8.0)
    y = spmd(lambda v: v * 2, mesh, in_layouts="S(0)",
             out_layouts="S(0)")(x)
    assert torch.equal(y, x * 2)
    with pytest.raises(RuntimeError, match="inside spmd"):
        M.psum(x, "d")
    assert list(itertools.chain(mesh.group(1, "d"))) == [0, 1, 2, 3]
