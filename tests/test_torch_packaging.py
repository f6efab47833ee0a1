"""The port installs whole: every package directory of
``mpi4torch_tpu_torch`` (one with an ``__init__.py``) is named in
``pyproject.toml``'s setuptools ``packages``, so an installed wheel holds
every module the package imports."""

import pathlib
import tomllib

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "mpi4torch_tpu_torch"


def _declared_packages():
    with open(ROOT / "pyproject.toml", "rb") as f:
        return set(tomllib.load(f)["tool"]["setuptools"]["packages"])


def _package_dirs():
    return {".".join(p.parent.relative_to(ROOT).parts)
            for p in PORT.rglob("__init__.py")}


def test_every_port_package_is_declared():
    missing = sorted(_package_dirs() - _declared_packages())
    assert not missing, f"pyproject.toml packages lacks {missing}"


def test_every_declared_port_package_exists():
    declared = {p for p in _declared_packages()
                if p.split(".")[0] == "mpi4torch_tpu_torch"}
    assert declared == _package_dirs()


def test_scan_sees_the_subpackages_the_port_imports():
    dirs = _package_dirs()
    for name in ("mpi4torch_tpu_torch", "mpi4torch_tpu_torch.compress",
                 "mpi4torch_tpu_torch.tune", "mpi4torch_tpu_torch.examples"):
        assert name in dirs
