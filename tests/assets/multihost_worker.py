"""Two-process jax.distributed worker (driven by test_parallel.py).

Validates the dp/sp-sharded quantized forward across REAL process
boundaries (the multi-host execution model, simulated on CPU devices):
each process owns 4 local devices of an 8-device mesh, cluster batches
shard over dp spanning processes, rows over sp, and the gathered
result must equal the single-device forward bit-for-bit.
"""
import os, sys
pid = int(sys.argv[1]); nproc = int(sys.argv[2]); port = sys.argv[3]
import jax
jax.distributed.initialize(
    coordinator_address=f"localhost:{port}", num_processes=nproc, process_id=pid)
import numpy as np, jax.numpy as jnp
sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
from qgtc_ppopp22.ops.digits import digit_pack
from qgtc_ppopp22.parallel import pod_mesh, host_batch_slice
from qgtc_ppopp22.parallel.sharded import dp_sp_epoch_step, shard_batches
from qgtc_ppopp22.models.qmodels import qgcn_forward

print(f"p{pid}: devices={jax.device_count()} local={jax.local_device_count()}", flush=True)
rng = np.random.default_rng(0)
bits, n, d = 2, 1024, 128
qa = (rng.random((n, n)) < 0.01).astype(np.int32)
qx = rng.integers(0, 4, (n, d)).astype(np.int32)
qws = [rng.integers(0, 4, (d, 128)).astype(np.int32) for _ in range(3)]
a = digit_pack(jnp.asarray(qa), 1); x = digit_pack(jnp.asarray(qx), bits)
ws = [digit_pack(jnp.asarray(w), bits) for w in qws]
mesh = pod_mesh(sp_per_host=4)
B = 4
a_stack = np.stack([np.asarray(a.digits)] * B)
x_stack = np.stack([np.asarray(x.digits)] * B)
with mesh:
    a_sh, x_sh = shard_batches(mesh, a_stack, x_stack)
    out = dp_sp_epoch_step(mesh, a_sh, x_sh, ws, bits, a_bits=1, x_bits=bits)
    out_local = np.asarray(jax.experimental.multihost_utils.process_allgather(out, tiled=True))
ref = np.asarray(qgcn_forward(a, x, ws, out_bits=bits))
ok = out_local.shape[0] == B and all(np.array_equal(out_local[i], ref[:n,:128]) for i in range(B))
print(f"p{pid}: MULTIHOST-{'OK' if ok else 'FAIL'} out={out_local.shape}", flush=True)

# --- packed MeshEngine EPOCH RUN across the 2 processes ------------
# Staging goes through host_batch_slice (each process materializes
# only its round-robin share of every stacked bucket; the global
# arrays are assembled shard-wise via
# jax.make_array_from_process_local_data — see MeshEngine._put), and
# several epochs run before the single gather, exercising the
# production multi-host execution path, not just one forward.
from qgtc_ppopp22.graph import ClusterBatcher, synthesize
from qgtc_ppopp22.parallel import MeshEngine
from qgtc_ppopp22.runtime import QGTCEngine

ds = synthesize("Proteins", scale=0.05, seed=0)
batcher = ClusterBatcher(ds, psize=8, batch_size=2, bit_width=2,
                         shuffle=False)
eng = MeshEngine(batcher.feat_dim, ds.num_classes, dp=8, sp=1,
                 model="gcn", bit_width=2, seed=0)
eng.stage(batcher)
out = None
for _ in range(3):
    out = eng._epoch_all(eng._all_args, eng._ws)
gath = [np.asarray(jax.experimental.multihost_utils.process_allgather(
            o, tiled=True)) for o in out]
ref_eng = QGTCEngine(batcher.feat_dim, ds.num_classes, model="gcn",
                     bit_width=2, seed=0)
ok2 = True
for (fn, args, bs, pn), g in zip(eng._staged, gath):
    for i, b in enumerate(bs):
        r = np.asarray(ref_eng.forward_batch(b))
        o = g[i][: b.num_nodes, : eng.cfg.out_dim]
        ok2 = ok2 and np.array_equal(
            r[: b.num_nodes, : eng.cfg.out_dim], o)
print(f"p{pid}: MESH-EPOCH-{'OK' if ok2 else 'FAIL'}", flush=True)

# --- per-process epoch walls: each process stages ceil(B/nproc) of
# the batches; its wall reflects its own share plus collective sync.
import time
n_epochs = 10
out = eng._epoch_all(eng._all_args, eng._ws)  # warm
jax.block_until_ready(out)
t0 = time.perf_counter()
for _ in range(n_epochs):
    out = eng._epoch_all(eng._all_args, eng._ws)
jax.block_until_ready(out)
wall = (time.perf_counter() - t0) * 1e3 / n_epochs
nb = 0  # this process's staged share (see MeshEngine.stage)
for (_f, _a, bs, _pn) in eng._staged:
    Bp = -(-len(bs) // eng.dp) * eng.dp
    sl = host_batch_slice(Bp)
    nb += max(0, min(sl.stop, Bp) - sl.start)
print(f"p{pid}: EPOCH-WALL ms={wall:.2f} local_batches={nb} "
      f"nproc={nproc}", flush=True)
