"""``python -m ctrlv_tpu_torch.tools.dryrun_multichip`` on two ``gloo`` ranks.

The counterpart of ``__graft_entry__.dryrun_multichip``: one data-parallel
stage-1 step over the (1, 2) mesh of two ranks, and one frame-sharded UNet
forward at F = 5 (3 + 2 frames) held inside the tool against the unsharded
forward (1e-4; the tool's ``FORWARD_TOL``).
"""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_dryrun_multichip_on_two_cpu_ranks(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "ctrlv_tpu_torch.tools.dryrun_multichip", "--nproc", "2",
         "--device", "cpu", "--store_dir", str(tmp_path)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    line = out.stdout.strip().splitlines()[-1]
    assert line.startswith("dryrun_multichip ok: mesh=(1x2), loss="), line
    assert "frame shards [(0, 3), (3, 5)]" in line


def test_the_parallel_modules_leave_jax_out():
    """The multi-card modules and the dry run import neither JAX, flax nor the
    JAX package: a rank on a card's machine has none of them."""
    code = ("import sys, ctrlv_tpu_torch.parallel, ctrlv_tpu_torch.parallel.launch, "
            "ctrlv_tpu_torch.tools.dryrun_multichip; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'ctrlv_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stdout + out.stderr[-2000:]
