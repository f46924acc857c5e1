"""Multi-process worker: one JAX process of a multi-controller run.

Launched by tests/test_multiprocess.py as ``python mp_worker.py
<process_id> <num_processes> <outfile> [port] [ndev] [mode]`` — the
analogue of one MPI rank under the reference CI's ``mpirun -np N``
(makefile-test.yml:59, np in {2, 4, 6}).  Each process owns ``ndev``
virtual CPU devices (default 4); jax.distributed stitches them into one
global mesh, and the framework runs UNCHANGED: cross-process halo
exchanges and reductions ride the same collectives (over Gloo here,
over NCCL between GPUs).  Process 0 writes its results for the test to
compare against a single-process run of the same program.

``mode`` ``"core"`` runs only the reference-CI oracle legs (hill halo,
checksum, scatter/gather round trip, flagship) — used for the np=4
(process seam on BOTH mesh axes) and np=6 (the reference's forced
non-square 3x2 process grid) gangs; ``"full"`` (default) adds the
framework-wide legs at np=2.
"""
import os
import sys

pid, nproc, outfile = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
port = sys.argv[4] if len(sys.argv) > 4 else "12957"
ndev = int(sys.argv[5]) if len(sys.argv) > 5 else 4
mode = sys.argv[6] if len(sys.argv) > 6 else "full"
os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={ndev}"
# environment.initialise()'s multihost autodetection keys on these:
os.environ["JAX_COORDINATOR_ADDRESS"] = f"localhost:{port}"
os.environ["JAX_NUM_PROCESSES"] = str(nproc)
os.environ["JAX_PROCESS_ID"] = str(pid)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", ndev)
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

import dl_esm_inf_tpu as dl  # noqa: E402
from dl_esm_inf_tpu.utils import compilation_cache  # noqa: E402

compilation_cache.enable()
dl.initialise()          # runs jax.distributed.initialize() (multihost)
assert jax.process_count() == nproc
assert len(jax.devices()) == ndev * nproc

results = {}

# --- hill halo oracle across the process boundary ----------------------
gnx, gny = 24, 20
grid = dl.Grid(dl.ARAKAWA_C,
               (dl.BC_EXTERNAL, dl.BC_EXTERNAL, dl.BC_NONE),
               dl.OFFSET_NE)
grid.decompose(gnx, gny, ndomains=ndev * nproc)
dl.grid_init(grid, 1.0, 1.0)
from dl_esm_inf_tpu.testing import init_field_hill  # noqa: E402

fld = dl.Field(grid, dl.T_POINTS)
init_field_hill(fld, -666.0)
fld.halo_exchange(1)
results["hill"] = fld.get_data()

# --- checksum oracle (cross-process psum) ------------------------------
ones = dl.Field(grid, dl.T_POINTS, init_global_data=np.ones((gny, gnx)))
results["gsum"] = np.asarray(dl.field_checksum(ones))

# --- scatter/gather round trip across processes ------------------------
vals = np.arange(gnx * gny, dtype=float).reshape(gny, gnx)
f2 = dl.Field(grid, dl.T_POINTS, init_global_data=vals)
f2.data = f2.data + 1.0
results["roundtrip"] = f2.gather_inner_data()

# --- the flagship model, 10 steps --------------------------------------
from dl_esm_inf_tpu.models import nemolite2d as nl  # noqa: E402
from dl_esm_inf_tpu.models.gravity_wave import gaussian_eta  # noqa: E402

m = nl.build(32, 32, ndomains=ndev * nproc, open_north=True)
m.set_initial_ssh(gaussian_eta(32, 32, amp=0.2))
m.run(10)
g = m.gather()
for k, v in g.items():
    results[f"nl_{k}"] = v

if mode == "core":
    # np=4 / np=6 gangs: reference-CI oracle legs only
    if pid == 0:
        np.savez(outfile, **results)
    print(f"[{pid}] MP WORKER DONE", flush=True)
    sys.exit(0)

# --- periodic wrap across the process boundary -------------------------
pgrid = dl.Grid(dl.ARAKAWA_C,
                (dl.BC_PERIODIC, dl.BC_PERIODIC, dl.BC_NONE),
                dl.OFFSET_NE)
pgrid.decompose(16, 16, ndomains=ndev * nproc)
dl.grid_init(pgrid, 1.0, 1.0)
pf = dl.Field(pgrid, dl.T_POINTS,
              init_global_data=np.arange(256.0).reshape(16, 16))
pf.halo_exchange(1)
results["periodic"] = pf.get_data()

# --- orbax sharded checkpoint: each process writes its own shards ------
from dl_esm_inf_tpu.utils import checkpoint  # noqa: E402

ckdir = os.path.join(os.path.dirname(outfile) or ".", "mp_ck")
checkpoint.save_fields_orbax(ckdir, {"ssh": m.sshn_t}, step=10)
fresh = dl.Field(m.grid, dl.T_POINTS)
step = checkpoint.load_fields_orbax(ckdir, {"ssh": fresh})
assert step == 10
assert np.array_equal(fresh.gather_inner_data(),
                      m.sshn_t.gather_inner_data())
results["ck_ok"] = np.asarray(1.0)

# --- fused kernel SCHEDULE across the process boundary -----------------
# (the metadata fast tier: one up-front exchange per application,
# ppermute crossing the process seam)
from dl_esm_inf_tpu.api.kernel_meta import (GO_READ, GO_WRITE, GO_CT,  # noqa: E402
                                            Schedule, go_arg,
                                            go_stencil, kernel)
from dl_esm_inf_tpu.ops import stencils as st  # noqa: E402


@kernel(args=[go_arg(GO_WRITE, GO_CT),
              go_arg(GO_READ, GO_CT, go_stencil(0, 11, 0))])
def mp_east(out, x):
    return st.xp(x)


fgrid = dl.Grid(dl.ARAKAWA_C,
                (dl.BC_EXTERNAL, dl.BC_EXTERNAL, dl.BC_NONE),
                dl.OFFSET_NE)
fgrid.decompose(32, 32, ndomains=ndev * nproc, halo_width=2, align_y=8)
dl.grid_init(fgrid, 1.0, 1.0)
fa = dl.Field(fgrid, dl.T_POINTS,
              init_global_data=np.arange(32.0 * 32).reshape(32, 32))
fb = dl.Field(fgrid, dl.T_POINTS)
fsched = Schedule((mp_east, fb, fa), (mp_east, fb, fb))
fsched.fused()
results["fused_sched"] = fb.gather_inner_data()

# --- semi-implicit solver: CG psum dots crossing the process seam ------
from dl_esm_inf_tpu.models import semi_implicit as si  # noqa: E402

msi = si.build(24, 24, ndomains=ndev * nproc, dt=1.0, depth=10.0,
               tol=1e-11)
msi.set_initial_eta(si.gaussian_eta(24, 24, amp=0.5))
msi.run(5)
for k, v in msi.gather().items():
    results[f"si_{k}"] = v

# ... and with the radiative open boundary (regression: its mask must
# build host-side — a sharded array can't be materialised here)
mso = si.build(24, 24, ndomains=ndev * nproc, dt=1.0, depth=10.0,
               tol=1e-11, open_north=True, bc_amp=0.05)
mso.run(5)
for k, v in mso.gather().items():
    results[f"sio_{k}"] = v

# --- ensemble + ETKF analysis across the process seam ------------------
# (member-coalesced halo exchange, the psum'd (M, M) obs moments, and
# the gather_to_host path of Ensemble.gather_all)
from dl_esm_inf_tpu.models import gravity_wave as gwm  # noqa: E402
from dl_esm_inf_tpu.models.enkf import ETKF  # noqa: E402
from dl_esm_inf_tpu.models.ensemble import Ensemble  # noqa: E402

gm = gwm.build(24, 24, ndomains=ndev * nproc, dt=0.05, depth=10.0)
rng = np.random.default_rng(5)
base = gaussian_eta(24, 24, amp=0.3)
ens = Ensemble(gm, 4)
ens.set_member_states(0, np.stack(
    [base + 0.1 * rng.standard_normal((24, 24)) for _ in range(4)]))
ens.run(4)
ETKF(ens, sigma=0.02).analysis(gaussian_eta(24, 24, amp=0.35))
ens.run(2)
for k, v in ens.gather_all().items():
    results[f"ek_{k}"] = v

# ... and a LOCALIZED analysis (per-point weights, batched eigh, obs
# extracted host-side — every process derives the identical obs list)
omask = np.zeros((24, 24))
omask[3:21:3, 3:21:3] = 1.0
ETKF(ens, sigma=0.02, localization_radius=4.0).analysis(
    gaussian_eta(24, 24, amp=0.3), obs_mask=omask)
ens.run(2)
for k, v in ens.gather_all().items():
    results[f"lk_{k}"] = v

# --- tracer transport across the process seam (reach-2 limiter) --------
from dl_esm_inf_tpu.models import tracer as trm  # noqa: E402

tu, tv = trm.streamfunction_velocities(
    0.4 * gaussian_eta(24, 24, amp=1.0, width=0.2))
mt = trm.build(24, 24, ndomains=ndev * nproc, dt=0.2, u=tu, v=tv,
               kappa=0.02)
mt.set_initial_tracer(gaussian_eta(24, 24, amp=1.0) + 0.01)
mt.run(8)
results["tr_c"] = mt.gather()["c"]

if pid == 0:
    np.savez(outfile, **results)
print(f"[{pid}] MP WORKER DONE", flush=True)
