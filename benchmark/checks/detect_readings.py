"""checks/readings.py with the detect cell's planted faults
(checks/detect_faults.py) registered: the same arguments and output.

    python3 benchmark/checks/detect_readings.py --workload ycbv-maskrcnn.frames --seconds 5 \
        --seeds 1 2 3
    python3 benchmark/checks/detect_readings.py --workload ycbv-maskrcnn.frames --seeds 1 2 3 \
        --fault proposals_cut

Needs a CUDA card, as a run does.
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

from benchmark.checks import detect_faults  # noqa: E402,F401  (registers the faults)
from benchmark.checks import readings  # noqa: E402

if __name__ == "__main__":
    sys.exit(readings.main(sys.argv[1:]))
