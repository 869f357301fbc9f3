"""Command-line entry point of the port (main, fibergen.cpp:27300-27354):

    python -m fibergen_tpu_torch.cli project.xml [actions_path]
        [--disable-python] [--device cpu|cuda]

runs a project on the card (``--device cpu``: the plain PyTorch path);
``--test`` runs the port's own tests (``tests/test_torch_*.py``).
"""
from __future__ import annotations

import argparse
import glob
import os
import sys


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="fibergen-tpu-torch",
        description="FFT homogenization on a CUDA card (fibergen-compatible "
                    "XML projects)")
    p.add_argument("project", nargs="?", help="XML project file")
    p.add_argument("actions_path", nargs="?", default="actions",
                   help="path of the actions list in the XML tree")
    p.add_argument("--test", action="store_true",
                   help="run the port's tests")
    p.add_argument("--disable-python", action="store_true",
                   help="disable Python evaluation of XML attributes")
    p.add_argument("--device", default=None,
                   help="torch device of the solve (default cuda)")
    args = p.parse_args(argv)

    if args.test:
        import pytest
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        return pytest.main(["-q", *sorted(glob.glob(
            os.path.join(root, "tests", "test_torch_*.py")))])

    if not args.project:
        p.print_help()
        return 1

    from .api import FG
    fg = FG(device=args.device)
    if args.disable_python:
        fg.set_py_enabled(False)
    fg.load_xml(args.project)
    return fg.run(args.actions_path)


if __name__ == "__main__":
    sys.exit(main())
