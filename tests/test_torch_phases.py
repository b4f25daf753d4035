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
        for n, (text, where) in zip(lines, phases.ANCHORS[kernel]):
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
