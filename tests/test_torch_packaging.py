"""An installed port holds every non-Python source it reads at run time.

The kernels build from ``csrc/*.cu`` and ``csrc/*.cuh`` (``ops._build``)
and the C++ helper from ``native/graph_ops.cpp`` (``native``); a wheel
holds them only where ``pyproject.toml``'s package data names them.  Each
non-Python file under ``graphs4cfd_tpu_torch/`` must match a pattern of
the package that owns it, and every package of the port must be found by
the ``packages.find`` include.
"""
import fnmatch
import tomllib
from pathlib import Path

from graphs4cfd_tpu_torch import native
from graphs4cfd_tpu_torch.ops import _build

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "graphs4cfd_tpu_torch"


def _setuptools():
    return tomllib.loads((ROOT / "pyproject.toml").read_text())["tool"][
        "setuptools"]


def _packaged(path: Path, package_data: dict) -> bool:
    """Whether a pattern of a package that holds ``path`` matches it."""
    for package, patterns in package_data.items():
        pkg_dir = ROOT.joinpath(*package.split("."))
        if pkg_dir not in path.parents:
            continue
        rel = path.relative_to(pkg_dir).as_posix()
        if any(fnmatch.fnmatchcase(rel, p) for p in patterns):
            return True
    return False


def test_package_data_names_every_source_the_port_reads():
    cu, cuh = _build._sources()
    read = set(cu) | set(cuh) | {native.SRC}
    found = {p for p in PORT.rglob("*") if p.is_file()
             and "__pycache__" not in p.parts and p.suffix not in (".py",
                                                                   ".pyc")}
    assert read <= found and len(cu) >= 10 and cuh
    package_data = _setuptools()["package-data"]
    missing = sorted(str(p.relative_to(ROOT)) for p in found
                     if not _packaged(p, package_data))
    assert not missing


def test_packages_find_includes_every_port_package():
    include = _setuptools()["packages"]["find"]["include"]
    packages = [".".join(p.parent.relative_to(ROOT).parts)
                for p in PORT.rglob("__init__.py")]
    assert "graphs4cfd_tpu_torch.native" in packages
    for name in packages:
        assert any(fnmatch.fnmatchcase(name, pat) for pat in include), name
