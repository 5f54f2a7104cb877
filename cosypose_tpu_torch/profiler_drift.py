"""How many of a torch.profiler session's device records come back in a
process on the card, as the process ages and after the things a long run
does (PERF.md §7: chip_smoke.py's short profiler sessions record nothing
from its phase 6 on).

    python -m cosypose_tpu_torch.profiler_drift        # on a machine with a card

Each check runs two CUDA-only sessions: one matmul and its sum and read-back
(4 device records when nothing is lost), and 2,000 small kernels (2,000).
The checks follow, in one process: more sessions, large sessions, a second
thread, subprocesses (one of them profiling the card itself), a DataLoader
with spawned workers, torch.export, idle time, and a wait inside the session
before its stop. Prints one line a check, with the seconds since the first
session began.
"""

from __future__ import annotations

import subprocess
import sys
import threading
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

CPU, CUDA = ProfilerActivity.CPU, ProfilerActivity.CUDA


def device_records(prof) -> int:
    return sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA)


def session(n_kernels: int, activities=(CUDA,), wait_s: float = 0.0) -> int:
    """Device records of one session of n_kernels small adds (0: one matmul,
    its sum and the read-back)."""
    x = torch.ones(256, 256, device="cuda")
    with profile(activities=list(activities)) as prof:
        if n_kernels:
            for _ in range(n_kernels):
                x += 1
        else:
            float((x @ x).sum())
        torch.cuda.synchronize()
        time.sleep(wait_s)
    return device_records(prof)


def main():
    t0 = time.time()

    def check(tag, wait_s=0.0):
        small = session(0, wait_s=wait_s)
        print(f"{time.time() - t0:6.1f} s  {tag}: one matmul {small} of 4 device records; "
              f"2,000 kernels {session(2000)}", flush=True)

    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    check("first")
    for _ in range(40):
        session(20)
    check("after 40 sessions of 20 kernels")
    session(10000, (CPU, CUDA))
    session(40000)
    check("after sessions of 10,000 (CPU+CUDA) and 40,000 kernels")
    done = threading.Event()
    thread = threading.Thread(target=done.wait)
    thread.start()
    check("with a second thread alive")
    done.set()
    thread.join()
    subprocess.run([sys.executable, "-c", "import torch; torch.ones(4, device='cuda').sum()"],
                   check=True)
    subprocess.run([sys.executable, "-c", "import torch\nfrom torch.profiler import profile\n"
                    "with profile(): torch.ones(4, device='cuda').sum().item()"], check=True)
    check("after subprocesses using and profiling the card")
    loader = torch.utils.data.DataLoader(list(range(64)), batch_size=8, num_workers=2,
                                         multiprocessing_context="spawn", pin_memory=True)
    for _ in loader:
        pass
    check("after a DataLoader with 2 spawned workers, pinned")
    net = torch.nn.Sequential(torch.nn.Conv2d(3, 8, 3), torch.nn.ReLU()).cuda().eval()
    with torch.no_grad():
        torch.export.export(net, (torch.zeros(2, 3, 32, 32, device="cuda"),)).module()(
            torch.zeros(2, 3, 32, 32, device="cuda"))
    check("after torch.export and a call of the program")
    for t in (30, 45, 60, 90):
        time.sleep(max(0.0, t - (time.time() - t0)))
        check("idle until now")
    check("waiting 0.5 s in the session before its stop", 0.5)
    check("waiting 3 s in the session before its stop", 3.0)


if __name__ == "__main__":
    main()
