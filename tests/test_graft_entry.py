"""Driver-contract tests: the multi-chip dry run must keep compiling+running."""

import os
import pathlib
import subprocess
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

REPO = pathlib.Path(__file__).resolve().parent.parent


def test_dryrun_multichip_8():
    import __graft_entry__

    __graft_entry__.dryrun_multichip(8)


def test_dryrun_multichip_bootstraps_like_the_driver():
    """Reproduce the driver's call environment: a fresh process with NO
    virtual-mesh env (1 visible device) imports the module and calls
    dryrun_multichip(8) directly. The bootstrap must not live only under
    __main__: the function re-executes itself on a virtual CPU mesh."""
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"  # only 1 device visible
    proc = subprocess.run(
        [sys.executable, "-c",
         "import __graft_entry__; __graft_entry__.dryrun_multichip(8); print('OK')"],
        env=env, cwd=str(REPO), capture_output=True, text=True, timeout=1700,
    )
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    assert "OK" in proc.stdout


def test_entry_shapes_declared():
    """entry() must build without executing (trace-level check only: building
    the 2.57B-param SDXL here would be slow on the CPU mesh, so just check the
    callable + args exist and are consistent)."""
    import __graft_entry__
    import inspect

    src = inspect.getsource(__graft_entry__.entry)
    assert "sdxl_base_unet_config" in src
    assert "compile_unet" in src
