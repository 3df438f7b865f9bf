import os

# Tests run on a virtual 8-device CPU mesh so multi-device sharding paths are
# exercised without accelerator hardware, and parity tests stay
# device-count-deterministic.  Tests marked `gpu` start their own child
# process on the card (see tests/test_gpu.py).
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import pathlib  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden"

# Disco's three per-iteration parameter files (disco.cfg, disco_2.cfg,
# disco_3.cfg): the settings the golden simplify fixtures were produced with.
PARAM_FILES = [str(GOLDEN / "params" / n)
               for n in ("disco.cfg", "disco_2.cfg", "disco_3.cfg")]
