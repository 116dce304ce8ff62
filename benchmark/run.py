"""Entry point: ``python3 benchmark/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the root of a checkout (see
``benchmark/harness.py``)."""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
