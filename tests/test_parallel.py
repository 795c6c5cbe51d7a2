"""Multi-device sharding tests on a virtual CPU mesh.

The reference has no distributed execution at all (SURVEY §2.3); these
tests validate the new mesh layer: row-sharded (sp) aggregation and
dp-over-batches stepping produce bit-identical results to the
single-device digit path.
"""

import numpy as np

from tests.conftest import run_on_cpu_mesh

CODE = r"""
import numpy as np, jax, jax.numpy as jnp
from qgtc_ppopp22.ops.digits import digit_pack, digit_unpack
from qgtc_ppopp22.models.qmodels import qgcn_forward
from qgtc_ppopp22.parallel import make_mesh, sp_gcn_forward, sp_gcn_forward_ring, sp_gin_forward, sp_gin_forward_ring, dp_sp_epoch_step, shard_batches

rng = np.random.default_rng(0)
bits, n, d, hid, cls = 2, 1024, 128, 64, 128
qa = (rng.random((n, n)) < 0.01).astype(np.int32)
qx = rng.integers(0, 4, (n, d)).astype(np.int32)
qws = [rng.integers(0, 4, s).astype(np.int32)
       for s in [(d, hid), (hid, hid), (hid, cls)]]
a = digit_pack(jnp.asarray(qa), 1)
x = digit_pack(jnp.asarray(qx), bits)
ws = [digit_pack(jnp.asarray(w), bits) for w in qws]

from qgtc_ppopp22.models.qmodels import qgin_forward
ref = np.asarray(qgcn_forward(a, x, ws, out_bits=bits))
ref_gin = np.asarray(qgin_forward(a, x, ws, out_bits=bits))

mesh = make_mesh(dp=1, sp=4)
with mesh:
    got = np.asarray(jax.jit(
        lambda a_, x_: sp_gcn_forward(mesh, a_, x_, ws, bits)
    )(a, x))
assert np.array_equal(got, ref[:n, :cls]), "sp forward mismatch"
print("SP-OK")

with mesh:
    got_gin = np.asarray(jax.jit(
        lambda a_, x_: sp_gin_forward(mesh, a_, x_, ws, bits)
    )(a, x))
assert np.array_equal(got_gin, ref_gin[:n, :cls]), "sp gin mismatch"
print("SP-GIN-OK")

with mesh:
    got_ring = np.asarray(jax.jit(
        lambda a_, x_: sp_gcn_forward_ring(mesh, a_, x_, ws, bits)
    )(a, x))
assert np.array_equal(got_ring, ref[:n, :cls]), "ring forward mismatch"
print("RING-OK")

with mesh:
    got_ring_gin = np.asarray(jax.jit(
        lambda a_, x_: sp_gin_forward_ring(mesh, a_, x_, ws, bits)
    )(a, x))
assert np.array_equal(got_ring_gin, ref_gin[:n, :cls]), "gin ring mismatch"
print("RING-GIN-OK")

mesh2 = make_mesh(dp=2, sp=4)
B = 4
a_stack = np.stack([np.asarray(a.digits)] * B)
x_stack = np.stack([np.asarray(x.digits)] * B)
with mesh2:
    a_sh, x_sh = shard_batches(mesh2, a_stack, x_stack)
    # default agg_mode is the ring schedule
    out = np.asarray(jax.jit(
        lambda a_, x_: dp_sp_epoch_step(mesh2, a_, x_, ws, bits,
                                        a_bits=1, x_bits=bits)
    )(a_sh, x_sh))
    out_gather = np.asarray(jax.jit(
        lambda a_, x_: dp_sp_epoch_step(mesh2, a_, x_, ws, bits,
                                        a_bits=1, x_bits=bits,
                                        agg_mode="gather")
    )(a_sh, x_sh))
    out_gin = np.asarray(jax.jit(
        lambda a_, x_: dp_sp_epoch_step(mesh2, a_, x_, ws, bits,
                                        a_bits=1, x_bits=bits,
                                        model="gin")
    )(a_sh, x_sh))
assert out.shape[0] == B
for i in range(B):
    assert np.array_equal(out[i], ref[:n, :cls]), f"dp batch {i} mismatch"
    assert np.array_equal(out_gather[i], ref[:n, :cls]), f"gather {i}"
    assert np.array_equal(out_gin[i], ref_gin[:n, :cls]), f"dp gin {i}"
print("DP-SP-OK")

# 8-bit shards: the int32 ring partials must stay exact where the old
# f32 round-trip would have lost bits past 2^24
bits8 = 8
qx8 = rng.integers(0, 256, (n, d)).astype(np.int32)
qws8 = [rng.integers(0, 256, s).astype(np.int32)
        for s in [(d, hid), (hid, hid), (hid, cls)]]
x8 = digit_pack(jnp.asarray(qx8), bits8)
ws8 = [digit_pack(jnp.asarray(w), bits8) for w in qws8]
from qgtc_ppopp22.models.qmodels import qgcn_forward as _qgcn
ref8 = np.asarray(_qgcn(a, x8, ws8, out_bits=bits8))
with mesh:
    got8 = np.asarray(jax.jit(
        lambda a_, x_: sp_gcn_forward_ring(mesh, a_, x_, ws8, bits8)
    )(a, x8))
assert np.array_equal(got8, ref8[:n, :cls]), "8-bit ring mismatch"
print("RING-8BIT-OK")
"""


PACKED_CODE = r"""
import numpy as np, jax, jax.numpy as jnp
from qgtc_ppopp22.graph import ClusterBatcher, synthesize
from qgtc_ppopp22.runtime import QGTCEngine
from qgtc_ppopp22.parallel import MeshEngine, dp_sp_epoch_packed, make_mesh
from qgtc_ppopp22.models.qmodels import qgcn_forward
from qgtc_ppopp22.ops.digits import digit_pack
from qgtc_ppopp22.ops.packmm import pack_rows_np
from jax.sharding import NamedSharding, PartitionSpec as P

# --- functional layer: packed ring step vs single-device forward ---
rng = np.random.default_rng(0)
for bits in (2, 8):
    n, d, hid, cls = 1024, 128, 64, 128
    qa = (rng.random((n, n)) < 0.01).astype(np.int32)
    qx = rng.integers(0, 1 << bits, (n, d)).astype(np.int32)
    qws = [rng.integers(0, 1 << bits, s).astype(np.int32)
           for s in [(d, hid), (hid, hid), (hid, cls)]]
    x = digit_pack(jnp.asarray(qx), bits)
    ws = [digit_pack(jnp.asarray(w), bits) for w in qws]
    a = digit_pack(jnp.asarray(qa), 1)
    ref = np.asarray(qgcn_forward(a, x, ws, out_bits=bits))
    B = 4
    a_words = pack_rows_np(qa, 1)
    a_stack = np.stack([a_words] * B)
    x_stack = np.stack([np.asarray(x.digits)] * B)
    mesh = make_mesh(dp=2, sp=4)
    with mesh:
        a_sh = jax.device_put(
            a_stack, NamedSharding(mesh, P("dp", None, "sp", None)))
        x_sh = jax.device_put(
            x_stack, NamedSharding(mesh, P("dp", None, "sp", None)))
        out = np.asarray(jax.jit(
            lambda a_, x_: dp_sp_epoch_packed(
                mesh, a_, x_, ws, bits, x_bits=bits, x_cols=d)
        )(a_sh, x_sh))
    for i in range(B):
        assert np.array_equal(out[i], ref[:n, :cls]), (bits, i)
    print(f"PACKED-RING-{bits}BIT-OK")

# --- MeshEngine end-to-end on real cluster batches, both modes ---
ds = synthesize("Proteins", scale=0.05, seed=0)
for model in ("gcn", "gin"):
    batcher = ClusterBatcher(ds, psize=8, batch_size=2, bit_width=2,
                             shuffle=False)
    ref_eng = QGTCEngine(batcher.feat_dim, ds.num_classes, model=model,
                         bit_width=2, seed=0)
    refs = [np.asarray(ref_eng.forward_batch(b)) for b in batcher.batches]
    for dp, sp in ((8, 1), (4, 2)):
        eng = MeshEngine(batcher.feat_dim, ds.num_classes, dp=dp, sp=sp,
                         model=model, bit_width=2, seed=0)
        outs = eng.forward_batches(batcher)
        for i, (r, o) in enumerate(zip(refs, outs)):
            assert np.array_equal(r[: o.shape[0], : o.shape[1]], o), (
                model, dp, sp, i)
        # accuracy parity: the mesh deployment scores IDENTICALLY to
        # the single-device engine
        acc_mesh = eng.evaluate(batcher, ds.labels)
        acc_ref = ref_eng.evaluate(batcher, ds.labels)
        assert acc_mesh == acc_ref, (model, dp, sp, acc_mesh, acc_ref)
    print(f"MESH-ENGINE-{model.upper()}-OK")
print("PACKED-ALL-OK")

# dp=2 on the 8-bit (two-digit, signed-packing) chain, with requant
# shifts: each device scans its shard; bit-exact vs one device
batcher = ClusterBatcher(ds, psize=8, batch_size=2, bit_width=8,
                         shuffle=False)
kw = dict(bit_width=8, seed=0, shifts=(2, 3, 4, 2, 3))
refs = QGTCEngine(batcher.feat_dim, ds.num_classes, **kw).forward_all(
    batcher)
eng = MeshEngine(batcher.feat_dim, ds.num_classes, dp=2, sp=1, **kw)
for r, o, b in zip(refs, eng.forward_batches(batcher), batcher.batches):
    assert np.array_equal(r[: b.num_nodes, : o.shape[1]], o)
print("DP-COMPACT-OK")
"""


def test_sharded_forward_matches_single_device():
    out = run_on_cpu_mesh(CODE, n_devices=8, timeout=900)
    assert "SP-OK" in out
    assert "SP-GIN-OK" in out
    assert "RING-OK" in out
    assert "RING-GIN-OK" in out
    assert "DP-SP-OK" in out
    assert "RING-8BIT-OK" in out


def test_packed_mesh_matches_single_device():
    """The packed path on the mesh: ring shards consume packed words,
    dp shards scan their batches; all bit-exact vs the single-device
    engine."""
    out = run_on_cpu_mesh(PACKED_CODE, n_devices=8, timeout=1800)
    assert "PACKED-RING-2BIT-OK" in out
    assert "PACKED-RING-8BIT-OK" in out
    assert "DP-COMPACT-OK" in out
    assert "MESH-ENGINE-GCN-OK" in out
    assert "MESH-ENGINE-GIN-OK" in out
    assert "PACKED-ALL-OK" in out


def test_multihost_helpers_single_process():
    """pod_mesh / host_batch_slice in the 1-process case."""
    code = r"""
import jax
from qgtc_ppopp22.parallel import pod_mesh, host_batch_slice, initialize
initialize(num_processes=1)  # no-op
mesh = pod_mesh()
assert mesh.shape["dp"] * mesh.shape["sp"] == jax.device_count()
sl = host_batch_slice(75)
assert sl == slice(0, 75), sl
print("MH-OK")
"""
    out = run_on_cpu_mesh(code, n_devices=8)
    assert "MH-OK" in out


def test_two_process_distributed_forward():
    """REAL multi-process execution (jax.distributed, 2 processes x 4
    CPU devices): the sharded quantized forward must be bit-exact."""
    import os
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    worker = os.path.join(
        os.path.dirname(os.path.abspath(__file__)),
        "assets", "multihost_worker.py",
    )
    env = dict(os.environ)
    env.update(
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=4",
        PYTHONPATH=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    procs = [
        subprocess.Popen(
            [sys.executable, "-u", worker, str(i), "2", str(port)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=600)
        outs.append(out)
        assert p.returncode == 0, out[-2000:]
    for i, out in enumerate(outs):
        assert f"p{i}: MULTIHOST-OK" in out, out[-2000:]
        assert f"p{i}: MESH-EPOCH-OK" in out, out[-2000:]
