"""Where a child process's ``ru_maxrss`` starts, on the machine it runs on.

Prints one JSON line: the ``ru_maxrss`` (bytes) that a fresh Python child
reports before it allocates anything, spawned by this process while it is
small, again while it holds 3 GiB of touched memory, and a grandchild
spawned through a small intermediate process while this one still holds
the 3 GiB. Where the child's figure tracks the parent's resident set,
``ru_maxrss`` growth inside a child says nothing about the child's own
peak; this is why ``chip_smoke.py``'s streaming phase reads its held
memory from ``/proc/self/smaps`` instead.

    python3 scripts/maxrss_probe.py
"""

import json
import subprocess
import sys

import numpy as np

_CODE = "import resource; print(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024)"


def _child_maxrss(cmd) -> int:
    out = subprocess.run(cmd, capture_output=True, text=True, check=True).stdout
    return int(out.split()[-1])


def main() -> int:
    child = [sys.executable, "-c", _CODE]
    small = _child_maxrss(child)
    held = np.ones((3 << 30) // 8)  # 3 GiB, every page touched
    big = _child_maxrss(child)
    via = _child_maxrss([
        sys.executable, "-c",
        "import subprocess, sys; print(subprocess.run([sys.executable, '-c', %r], "
        "capture_output=True, text=True, check=True).stdout)" % _CODE,
    ])
    print(json.dumps({
        "parent_held_bytes": int(held.nbytes),
        "child_of_small_parent": small,
        "child_of_large_parent": big,
        "grandchild_through_small_process": via,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
