"""The extension kernel's share of its roofline (%): the least time of
every B4 launch of the window (its pairs, rows, band and plane, taken at
ops/extend's one launching entry; the rows each pass needs; bounds from
gpubench/bounds.py) over the device time of B4's kernels
(extend_scan_kernel, extend_wave_kernel in csrc/extend_scan.cu)."""


def read(run):
    if run.trace is None:
        return None
    t = run.trace.seconds(r"\b(extend_scan|extend_wave)_kernel\b")
    need = run.b4.bound_s()
    if t <= 0 or need is None:
        return None
    return 100.0 * need / t
