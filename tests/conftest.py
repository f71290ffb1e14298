"""Test configuration.

The suite runs on the CPU (``JAX_PLATFORMS=cpu``) over 8 virtual devices,
so the multi-device sharding tests run here, with float64 enabled so the
GFI regression constants from the reference test-suite
(modppl/tests/dyngenfn.rs) can be checked at 1e-6. The platform is also
forced through ``jax.config`` in case jax was imported before this file.

The program itself runs on GPUs: ``python chip_smoke.py`` (one card),
``python chip_smoke.py --four`` (four cards) and ``python bench.py``; their
phase functions are exercised here at tiny sizes.
"""

import os
import sys

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Build the native C extensions in-place if missing OR unloadable (a .so
# left behind by a different toolchain/ABI exists but fails to dlopen —
# find_spec alone cannot tell). This must NOT import anything under
# modppl_tpu: the package __init__ pulls in core.trie, which computes
# HAVE_NATIVE_TRIE at import time — rebuilding after that is too late for
# this process. Hence the dlopen probe + inline compile (mirrors
# modppl_tpu/native/build.py) instead of calling the build module.
def _ensure_native_extensions():
    import ctypes
    import subprocess
    import sysconfig

    nd = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "modppl_tpu", "native")
    suffix = sysconfig.get_config_var("EXT_SUFFIX")
    stale = False
    for name in ("_addrops", "_ctrie"):
        try:
            ctypes.CDLL(os.path.join(nd, name + suffix))
        except OSError:
            stale = True
    if stale:
        cc = os.environ.get("CC", "gcc")
        include = sysconfig.get_path("include")
        for name in ("addrops", "ctrie"):
            subprocess.run(
                [cc, "-O2", "-fPIC", "-shared", f"-I{include}",
                 os.path.join(nd, name + ".c"),
                 "-o", os.path.join(nd, "_" + name + suffix)],
                check=True)


try:
    _ensure_native_extensions()
except Exception:
    pass

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

assert jax.devices()[0].platform == "cpu", "tests must run on the CPU backend"
assert len(jax.devices()) == 8, "tests expect an 8-device virtual CPU mesh"
