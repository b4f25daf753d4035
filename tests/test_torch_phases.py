"""The phase-stamping tool (skirt_tpu_torch.experiments.phases) on the CPU:
the stamped sources it would build on the card, checked as text."""

import re

import pytest

from skirt_tpu_torch import kernels
from skirt_tpu_torch.experiments import phases


@pytest.mark.parametrize("kernel", sorted(phases.KERNELS))
def test_stamped_source_marks_each_phase(kernel):
    """Every kernel gets a `prof` pointer at the end of its argument
    struct and one stamp per phase boundary, numbered 0, 1, ... in the
    order the thread passes them; the lines reported are those of the
    source's barriers (per-block stamps) or anchors (per-warp stamps)."""
    source, struct, _, _ = phases.KERNELS[kernel]
    src = (kernels.CSRC / source).read_text()
    out, lines, per_block = phases.stamped_source(src, kernel)
    body = re.search(r"struct %s \{(.*?)\n\};" % struct, out, re.S).group(1)
    assert body.rstrip().endswith("unsigned long long* prof;")
    macro = "PROF" if per_block else "PROFW"
    stamps = [int(m) for m in re.findall(r"\n  %s\((\d+)\);" % macro, out)]
    # per block: the start, after each barrier, and the end
    nstamp = len(lines) + 2 if per_block else len(lines)
    assert sorted(stamps) == list(range(nstamp))
    src_lines = src.splitlines()
    if per_block:
        assert all(src_lines[n - 1] == "  __syncthreads();" for n in lines)
    else:
        anchors = phases.anchor_set(src, kernel, 0, len(src))
        assert len(anchors) == len(lines)
        for n, (text, where) in zip(lines, anchors):
            line = src_lines[n - (2 if where == "after" else 1)]
            assert line.startswith(text.split("\n")[0])
    assert out.count("gtimer()") == 3


def test_stamped_source_refuses_a_missing_anchor():
    """A one-thread-per-lane source without an anchor's line is refused,
    not stamped in the wrong place."""
    src = (kernels.CSRC / "fused_mono.cu").read_text()
    src = src.replace("// -- local mixture", "// -- the local mixture")
    with pytest.raises(RuntimeError, match="anchor"):
        phases.stamped_source(src, "k3")


@pytest.mark.parametrize("kernel, design", [
    ("k5", "one-thread"), ("k5", "first"), ("k6", "first")])
def test_anchor_sets_follow_the_design(kernel, design):
    """K5's one-thread form is stamped per warp at its own anchors, and a
    first-design K5 or K6 (one thread per lane, as a parent tree still
    holds it, rebuilt here from its anchor lines) at the anchors of that
    design: the set chosen is the one whose every line the source holds."""
    sets = phases.ANCHORS[kernel]
    want = sets[0] if design == "one-thread" else sets[-1]
    if design == "one-thread":
        src = (kernels.CSRC / phases.KERNELS[kernel][0]).read_text()
    else:
        # a skeleton of the first design: its struct, then the kernel's
        # lines in order, each anchor's own line among them
        source, struct, sig, _ = phases.KERNELS[kernel]
        src = (f"struct {struct} {{\n  int N;\n}};\n"
               f"__global__ void {sig}const {struct} a) {{\n"
               + "".join(text + "\n  x();\n" for text, _ in want)
               + "}\n")
    assert phases.anchor_set(src, kernel, 0, len(src)) == want
    out, lines, per_block = phases.stamped_source(src, kernel)
    assert not per_block and len(lines) == len(want)
    assert out.count("  PROFW(") == len(want)


@pytest.mark.parametrize("kernel, threads", [
    ("k6", [0, 1, 2, 4, 16]), ("k6", [2]), ("k7", [2, 8])])
def test_force_threads_hooks_each_launch(kernel, threads):
    """--threads on K6's and K7's dispatch: one early return per listed
    width into that kernel's launch_g, refusing a W beyond what the
    instance holds, behind one global the tool sets; 0 adds nothing."""
    src = (kernels.CSRC / phases.KERNELS[kernel][0]).read_text()
    launch, targs, tail = phases.DISPATCH[kernel]
    assert src.count(launch) == 1
    out = phases.force_threads(src, threads, kernel)
    assert out.count("int phases_threads = 0;") == 1
    for g in threads:
        if not g:
            continue
        assert f"if (phases_threads == {g})" in out
        assert f"launch_g<{targs}, {g}{tail}>(a, s);" in out
        assert f"a.W > {g} * wpt<{g}>()" in out
    assert "phases_threads == 0" not in out


def test_smoke_subset_names_map_to_phases():
    """Every kernel phase chip_smoke.py runs alone (the names ab_trees'
    --smoke passes) maps to a phase function taking (torch, results), and
    the table kernels K5, K6, K6d and K6p are among them."""
    import inspect

    import chip_smoke

    assert {"k1", "k2", "k3", "k5", "k6", "k6d", "k6p", "k7"} <= set(
        chip_smoke.SUBSET)
    for name, fn in chip_smoke.SUBSET.items():
        assert callable(fn), name
        assert len(inspect.signature(fn).parameters) == 2, name
    # ab_trees knows the cells that run K5 and K6 and their profiles
    from skirt_tpu_torch.experiments import ab_trees
    for cell in ("octree-poly", "multi-mono", "vor-voxel",
                 "vor-direct-poly", "pol-table-poly"):
        assert cell in ab_trees.CELLS
    assert {"octree-poly", "multi-mono"} <= set(ab_trees.PROFILES)


def test_force_threads_hooks_k7_launch():
    """--threads: K7's dispatch gains one early return per listed width,
    each refusing a W beyond what that instance holds, behind a global
    the tool sets; 0 adds nothing."""
    src = (kernels.CSRC / "fused_table_poly_multi.cu").read_text()
    out = phases.force_threads(src, [0, 2, 16])
    assert out.count("int phases_threads = 0;") == 1
    for g in (2, 16):
        assert f"if (phases_threads == {g})" in out
        assert f"a.W > {g} * wpt<{g}>()" in out
        assert f"launch_g<H, LABS, {g}>(a, s);" in out
    assert "phases_threads == 0" not in out
    with pytest.raises(RuntimeError, match="dispatch"):
        phases.force_threads(src.replace("int launch(", "int go("), [2])
