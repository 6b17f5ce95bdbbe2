"""Every kernel of the port has its two homes on the card: a test of the
GPU tier (tests/test_torch_kernels_gpu.py, marker gpu) that holds it
against its plain version, found by its name, and a timed case of
tools/torch_kernel_ab.py's CASES.  The kernels are the keys of
utils.profiling.launch_counts() but the plain versions' (*_plain) and
"fly" (every launch of the fly kernel, which k5, k6, k7 and k3_fly
split).  A kernel's tests carry its key as a part of their name
(test_k1_small, test_k3_volume_form, test_bfv_...), the fly kernel's
variants `fly` (test_fly_kernel_one_level).  The GPU file is read with
ast, not imported; the tool is imported (at import it loads nothing of
the package).
"""

import ast
import importlib.util
import os

import pytest

from crossscalepatchmatch_tpu_torch.utils.profiling import launch_counts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS = [k for k in launch_counts()
           if k != "fly" and not k.endswith("_plain")]
FLY_VARIANTS = ("k5", "k3_fly", "k6", "k7")


def gpu_tier():
    """(the GPU file's test functions, whether its module is marked
    gpu)."""
    path = os.path.join(REPO, "tests", "test_torch_kernels_gpu.py")
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    tests, marked = set(), False
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and node.name.startswith(
                "test_"):
            tests.add(node.name)
        elif isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                getattr(node.targets[0], "id", None) == "pytestmark":
            marked = ast.unparse(node.value) == "pytest.mark.gpu"
    return tests, marked


def kernel_tests(kernel, tests):
    """The tests whose name holds the kernel's key (`fly` for the fly
    kernel's variants) as a part between underscores."""
    part = "fly" if kernel in FLY_VARIANTS else kernel
    return {t for t in tests if f"_{part}_" in f"{t}_"}


def timing_cases():
    spec = importlib.util.spec_from_file_location(
        "torch_kernel_ab", os.path.join(REPO, "tools", "torch_kernel_ab.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.CASES


@pytest.mark.parametrize("kernel", KERNELS)
def test_kernel_has_a_card_test_and_a_timing(kernel):
    tests, marked = gpu_tier()
    assert marked
    assert kernel_tests(kernel, tests), kernel
    assert timing_cases().get(kernel), kernel
