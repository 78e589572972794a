"""Real multi-process execution: 2 OS processes × 4 CPU devices each.

The reference CI validates MPI parallelism with genuine ``mpiexec -n
{2,3,4}`` process launches (reference
``.github/workflows/test_package.yml:33-45``).  This is the JAX
analog: two OS processes join one JAX distributed runtime
(``jax.distributed.initialize`` via ``parallel.multihost.ensure_distributed``
— the real entry, not the mocks of ``test_multihost.py``) over gloo CPU
collectives, and every process asserts sharded == serial on a tree (blocked
path) and a lattice (strip-sharded grid path).  Host pulls of
process-spanning arrays exercise ``parallel.sharding._to_host``'s
``process_allgather`` branch, which single-process tests cannot reach.
"""

import socket
import subprocess
import sys
from pathlib import Path

WORKER = Path(__file__).resolve().parent / "_mp_worker.py"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_distributed_sharded_matches_serial():
    nproc = 2
    port = _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, str(WORKER), str(pid), str(nproc), str(port)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for pid in range(nproc)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=420)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-4000:]}"
        assert f"MP_OK[{pid}]" in out, f"worker {pid} incomplete:\n{out[-4000:]}"
        # all three topology classes ran on every process
        assert f"MP_CHECK[{pid}] tree:" in out
        assert f"MP_CHECK[{pid}] grid:" in out
        assert f"MP_CHECK[{pid}] web:" in out
