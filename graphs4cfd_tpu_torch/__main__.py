"""The port's command line (counterpart of ``graphs4cfd_tpu/__main__.py``).

Usage:
    python -m graphs4cfd_tpu_torch info
    python -m graphs4cfd_tpu_torch convert SRC.chk DST.chk
    python -m graphs4cfd_tpu_torch train SCRIPT.py [ARGS ...]
    python -m graphs4cfd_tpu_torch bench | scaling

``info`` prints the versions, the CUDA devices and, on a card, builds or
loads the kernel library; run it first on a new machine.  A failed build
of the kernels or of the C++ helper exits non-zero with the compiler's
message.  ``bench`` and ``scaling`` exit non-zero: the port has no
benchmark script yet.
"""
from __future__ import annotations

import argparse
import runpy
import sys


def cmd_info(_args):
    import torch
    import graphs4cfd_tpu_torch as gfd
    print(f"graphs4cfd_tpu_torch {gfd.__version__}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda or 'none'}")
    cuda = torch.cuda.is_available()
    if cuda:
        for i in range(torch.cuda.device_count()):
            cap = torch.cuda.get_device_capability(i)
            print(f"  device cuda:{i}: {torch.cuda.get_device_name(i)}, "
                  f"compute capability {cap[0]}.{cap[1]}")
    else:
        print("  no CUDA device: the CUDA kernels are not built; CPU "
              "tensors run their plain versions")
    from graphs4cfd_tpu_torch import native
    from graphs4cfd_tpu_torch.ops import _build
    try:
        if cuda:
            print(f"CUDA kernels: building or loading {_build.library_path()}"
                  " (a first build takes about 2 minutes) ...", flush=True)
            _build.load()
            b = _build.build_info
            print(f"CUDA kernels: {b['path']} ("
                  f"{'built' if b['built'] else 'cached'} in "
                  f"{b['seconds']:.1f} s)")
        native.load()
        b = native.build_info
        print(f"C++ helper: {b['path']} ("
              f"{'built' if b['built'] else 'cached'} in "
              f"{b['seconds']:.1f} s)")
    except RuntimeError as err:
        sys.exit(f"graphs4cfd_tpu_torch info: {err}")


def cmd_no_benchmark(args):
    sys.exit(f"graphs4cfd_tpu_torch {args.cmd}: the PyTorch port has no "
             "benchmark script yet; bench.py and bench_scaling.py measure "
             "the JAX package only")


def cmd_convert(args):
    from graphs4cfd_tpu_torch.training.checkpoint import \
        convert_reference_checkpoint
    out = convert_reference_checkpoint(args.src, args.dst)
    print(f"converted {args.src} -> {args.dst} "
          f"({len(out['arch'])} arch entries)")


def cmd_train(args):
    sys.argv = [args.script] + args.rest
    runpy.run_path(args.script, run_name="__main__")


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m graphs4cfd_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    sub.add_parser("info", help="versions, devices, kernel library")
    sub.add_parser("bench", help="not in the port yet (exits non-zero)")
    sub.add_parser("scaling", help="not in the port yet (exits non-zero)")
    sp = sub.add_parser("convert",
                        help="convert a reference PyTorch .chk checkpoint")
    sp.add_argument("src")
    sp.add_argument("dst")
    sp = sub.add_parser("train", help="run a training script")
    sp.add_argument("script")
    sp.add_argument("rest", nargs=argparse.REMAINDER)
    args = p.parse_args(argv)
    {"info": cmd_info, "bench": cmd_no_benchmark,
     "scaling": cmd_no_benchmark, "convert": cmd_convert,
     "train": cmd_train}[args.cmd](args)


if __name__ == "__main__":
    main()
