"""psnumerics on the port, the CLI: ``python -m ps_pytorch_tpu_torch.check
--device cpu --select PSC111,PSC112,PSC113,PSC114`` records the whole
registry on the CPU and exits 0 with zero findings, the exit code and
the report of JAX's pscheck.
"""

import contextlib
import io
import json

from ps_pytorch_tpu_torch.check.__main__ import main as check_main
from tests.test_torch_one_thread import _one_thread  # noqa: F401


def test_torch_cli_numerics_rules_hold_over_the_registry():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = check_main(["--device", "cpu", "--format", "json",
                         "--select", "PSC111,PSC112,PSC113,PSC114"])
    report = json.loads(buf.getvalue())
    assert rc == 0 and report["findings"] == []
    assert len(report["configs"]) == 37 and report["device"] == "cpu"
