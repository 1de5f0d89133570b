"""torchlint ``kernel-budget`` — the numeric half of the kernels' shared
memory accounting (rules.py holds the AST half; the port's counterpart of
cocoa_tpu/analysis/pallas_budget.py).

No kernel asks the card how much shared memory to use: each wrapper sizes
its blocks with a plan in Python (``ops/sparse_sdca.py sparse_plan``,
``ops/dense_sdca.py stage_plan``, ``ops/block_chain.py chain_plan`` and
``fused_plan``, ``ops/sparse_block.py gram_plan`` and ``apply_plan``),
held to the opt-in ``kernels.smem_optin`` reads, and the C launcher
refuses a plan that breaks its rules.  Two halves check that arithmetic:

- **the CPU half** (:func:`run_budget_checks`, in ``python -m
  cocoa_torch.analysis``) imports the plan modules, which build nothing,
  and sweeps every plan over the main paths' shapes (PERF.md section 4)
  and the corners where a plan must stream or refuse, at the H100's
  opt-in (:data:`SMEM_OPTIN`): wherever a plan accepts a shape its bytes
  are within the opt-in and its depth, chunk or slice count is at least
  one;
- **the card half** (:func:`card_report`, run by ``chip_smoke.py`` phase
  25) reads each kernel's registers, static shared memory, spill bytes
  and most threads a block through its library's ``kernel_info`` entry
  (csrc/sdca_common.cuh ``SDCA_KERNEL_INFO``: ``cudaFuncGetAttributes``
  and ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), at the block
  and the dynamic bytes of the plan at each main-path shape: static plus
  dynamic within ``kernels.smem_optin`` of the card, and at least one
  block an SM, else the launch would fail.
"""

from __future__ import annotations

import ctypes
import dataclasses
import inspect

from cocoa_torch.analysis.core import Finding
from cocoa_torch.ops import block_chain as bc
from cocoa_torch.ops import dense_sdca as ds
from cocoa_torch.ops import sparse_block as sb
from cocoa_torch.ops import sparse_sdca as ss

# the H100's opt-in shared memory of a block (ops/block_chain.py, the
# fused plan's constant) and its SMs (an H100 SXM)
SMEM_OPTIN = 232_448
SMS = 132
ITEMSIZES = {4: "float", 8: "double"}

# the kernels' block sizes (csrc/: sparse_sdca.cu 32 a warp and
# kStepThreads = 544, dense_sdca.cu kThreads, block_chain.cu
# kChainThreads = 32 + 256 producers and kThreads, sparse_block.cu
# kThreads and kApplyThreads, draw_tables.cu)
B1H_STEP_THREADS = ss.PANEL_THREADS + 32
CHAIN_THREADS = 288
FUSED_THREADS = 256
GRAM_THREADS = 256

# main-path shapes (PERF.md section 4; chip_smoke.py RCV1_SHAPE and the
# rest): B1 (row width W, d); B1h (residual W, d, panel lanes); B2 (row
# length d); B3 and B4 (B, d); B5 (B, W); B6 (K, B, W, d)
B1_SHAPES = {"rcv1-like": (548, 47236), "demo": (283, 9947),
             "demo columns (prox)": (1738, 2000)}
B1H_SHAPES = {"rcv1-like hybrid": (174, 47236, 5248)}
B2_SHAPES = {"epsilon-like": 2000, "demo dense": 9947,
             "lasso design": 8192, "tall lasso design": 100_000}
B3_SHAPES = {"rcv1-like block": 128, "epsilon-like split 256": 256,
             "epsilon-like split 512": 512, "largest B": bc.CHAIN_MAX_B}
B4_SHAPES = {"epsilon-like fused": (128, 2000), "lasso fused": (128, 8192),
             "tall lasso fused": (128, 100_000)}
B5_SHAPES = {"rcv1-like block": (128, 548), "rcv1-like hybrid": (128, 174),
             "demo columns": (128, 1738), "wide W=1560": (128, 1560),
             "wide W=20000": (128, 20000), "wide W=1028": (128, 1028)}
B6_SHAPES = {"rcv1-like block": (8, 128, 548, 47236),
             "demo columns": (4, 128, 1738, 2000),
             "rcv1-like hybrid": (8, 128, 174, 47236)}


@dataclasses.dataclass
class Case:
    """One kernel at one plan: the library and the kernel's table name,
    its block's threads and the plan's dynamic shared memory."""
    tag: str
    label: str
    lib: str
    kernel: str
    threads: int
    dyn: int
    plan: tuple


def _line(fn) -> int:
    return inspect.unwrap(fn).__code__.co_firstlineno


def main_path_cases(smem_optin: int = SMEM_OPTIN, sms: int = SMS) -> list:
    """Every kernel at the plan its wrapper takes at each main-path shape,
    in float32 and float64 (raises what a plan raises)."""
    cases = []
    for it, t in ITEMSIZES.items():
        for label, (w, d) in B1_SHAPES.items():
            plan = ss.sparse_plan(w, d, it, smem_optin)
            place = "smem" if plan[0] else "global"
            cases.append(Case(
                "B1", f"{label} {t}", "sparse_sdca",
                f"sparse_sdca_round_kernel<{t},{place}>",
                32 * (plan[1] + 1),
                ss.plan_bytes(d, 0, it, plan[0], plan[3], plan[1], plan[2]),
                plan))
        for label, (w, d, n_hot) in B1H_SHAPES.items():
            plan = ss.sparse_plan(w, d, it, smem_optin, n_hot=n_hot)
            place = "smem" if plan[0] else "global"
            lanes = "regs" if plan[3] else "memory"
            cases.append(Case(
                "B1h", f"{label} {t}", "sparse_sdca",
                f"sparse_sdca_hybrid_kernel<{t},{place},{lanes}>",
                B1H_STEP_THREADS + 32 * plan[1],
                ss.plan_bytes(d, n_hot, it, plan[0], plan[3], plan[1],
                              plan[2]), plan))
        for label, d in B2_SHAPES.items():
            plan = ds.stage_plan(d, it, smem_optin)
            place = "smem" if plan[0] else "global"
            shape = "chunked" if plan[2] < d else "whole"
            cases.append(Case(
                "B2", f"{label} {t}", "dense_sdca",
                f"dense_sdca_round_kernel<{t},{place},{shape}>", ds.THREADS,
                ds.plan_bytes(d, it, *plan), plan))
        for label, b in B3_SHAPES.items():
            plan = bc.chain_plan(b, it, smem_optin)
            cases.append(Case(
                "B3", f"{label} {t}", "block_chain",
                f"chain_kernel<{t},{_rows_unit(b)}>", CHAIN_THREADS,
                plan[2], plan))
        for label, (b, d) in B4_SHAPES.items():
            plan = bc.fused_plan(b, d, it)
            cases.append(Case(
                "B4", f"{label} {t}", "block_chain",
                f"fused_kernel<{t},{_rows_unit(b)}>", FUSED_THREADS,
                bc.fused_smem_bytes(b, it), plan))
        for label, (b, w) in B5_SHAPES.items():
            plan = sb.gram_plan(b, w, it, smem_optin)
            tables = sb.gram_tables(b, plan.blocks)
            kern = ("gram_kernel" if plan.chunk >= w and plan.cap >= w
                    else "gram_pass_kernel")
            cases.append(Case(
                "B5", f"{label} {t}", "sparse_block",
                f"{kern}<{t},{tables}>", GRAM_THREADS, plan.smem,
                tuple(plan)))
        for label, (k, b, w, d) in B6_SHAPES.items():
            plan = sb.apply_plan(k, b, w, d, it, smem_optin, sms)
            cases.append(Case(
                "B6", f"{label} {t}", "sparse_block", f"apply_kernel<{t}>",
                32 * sb.APPLY_WARPS, plan.smem, tuple(plan)))
    for kern, threads in (("reference_kernel", 128), ("hash_kernel", 256),
                          ("permuted_kernel", 256)):
        cases.append(Case("D", kern.split("_")[0], "draw_tables", kern,
                          threads, 0, ()))
    return cases


def _rows_unit(b: int) -> int:
    """block_chain.cu's R for B: the rows a lane of the chain's warp
    holds, as its launchers pick the instantiation."""
    return 4 if b <= 128 else 8 if b <= 256 else 16 if b <= 512 else 32


def _finding(fn, message: str) -> Finding:
    mod = inspect.unwrap(fn).__module__
    return Finding(rule="kernel-budget", severity="error",
                   path=mod.replace(".", "/") + ".py", line=_line(fn),
                   col=0, message=message)


def check_constants() -> list:
    """The fused plan's opt-in constant is the H100's (the plan holds B4
    to it without asking the card)."""
    if bc.SMEM_OPTIN != SMEM_OPTIN:
        return [_finding(bc.fused_plan,
                         f"ops/block_chain.py SMEM_OPTIN = {bc.SMEM_OPTIN} "
                         f"is not the H100's opt-in {SMEM_OPTIN}")]
    return []


def check_plans(smem_optin: int = SMEM_OPTIN) -> list:
    """Every plan at every main-path shape within ``smem_optin``, with a
    depth, chunk and slice count of at least one."""
    findings = []
    plans = {"B1": ss.sparse_plan, "B1h": ss.sparse_plan,
             "B2": ds.stage_plan, "B3": bc.chain_plan, "B4": bc.fused_plan,
             "B5": sb.gram_plan, "B6": sb.apply_plan, "D": None}
    try:
        cases = main_path_cases(smem_optin)
    except ValueError as e:
        return [_finding(bc.chain_plan, f"a plan refused a main-path shape: "
                                        f"{e}")]
    for c in cases:
        if c.tag == "D":
            continue
        fn = plans[c.tag]
        if c.dyn > smem_optin:
            findings.append(_finding(
                fn, f"{fn.__name__} at {c.label} plans {c.dyn} bytes of "
                    f"shared memory, over the opt-in {smem_optin}"))
        if any(isinstance(v, int) and not isinstance(v, bool) and v < 1
               for v in c.plan):
            findings.append(_finding(
                fn, f"{fn.__name__} at {c.label} picks {c.plan}: a depth, "
                    f"chunk or count below 1"))
    return findings


def _expect_refusal(fn, *args, **kw) -> bool:
    try:
        fn(*args, **kw)
    except ValueError:
        return True
    return False


def check_corners(smem_optin: int = SMEM_OPTIN) -> list:
    """The shapes where a plan must stream or refuse: B2 past a whole row
    in one slot (58 048 float32 / 28 992 float64 values at the H100's
    opt-in, beside the partial dots) streams it in chunks; B1 past its
    slot streams the row's tail; B3 past CHAIN_MAX_B, B4 past its working
    set and B6 past APPLY_MAX_B refuse."""
    findings = []
    for it in ITEMSIZES:
        whole = (smem_optin - ds.plan_bytes(0, it, False, 0, 0)) // it
        at = ds.stage_plan(whole, it, smem_optin)
        past = ds.stage_plan(whole + 1, it, smem_optin)
        if at[2] != whole or past[2] >= whole + 1 \
                or ds.plan_bytes(whole + 1, it, *past) > smem_optin:
            findings.append(_finding(
                ds.stage_plan,
                f"stage_plan at d={whole} / {whole + 1} ({it}-byte values) "
                f"picks {at} / {past}: a whole row at the boundary, chunks "
                f"past it, within {smem_optin} bytes, expected"))
        plan = ss.sparse_plan(20000, 40000, it, smem_optin)
        if plan[2] >= 20000 or ss.plan_bytes(
                40000, 0, it, plan[0], plan[3], plan[1], plan[2]) \
                > smem_optin:
            findings.append(_finding(
                ss.sparse_plan,
                f"sparse_plan at W=20000 ({it}-byte values) picks {plan}: "
                f"a slot narrower than the row, within the opt-in, "
                f"expected"))
        if not _expect_refusal(bc.chain_plan, bc.CHAIN_MAX_B + 1, it,
                               smem_optin):
            findings.append(_finding(
                bc.chain_plan, f"chain_plan accepts B={bc.CHAIN_MAX_B + 1}, "
                               f"past CHAIN_MAX_B"))
        big = 2 * 128
        while bc.fused_smem_bytes(big, it) <= SMEM_OPTIN:
            big *= 2
        if not _expect_refusal(bc.fused_plan, big, 2000, it):
            findings.append(_finding(
                bc.fused_plan, f"fused_plan accepts B={big} ({it}-byte "
                               f"values), whose working set is over the "
                               f"opt-in"))
        if not _expect_refusal(sb.apply_plan, 8, sb.APPLY_MAX_B + 1, 548,
                               47236, it, smem_optin, SMS):
            findings.append(_finding(
                sb.apply_plan, f"apply_plan accepts B={sb.APPLY_MAX_B + 1}, "
                               f"past APPLY_MAX_B"))
    return findings


def run_budget_checks() -> list:
    """The full numeric kernel-budget pass; a plan API that drifted out
    from under the sweep is a finding, not a crash."""
    try:
        return check_constants() + check_plans() + check_corners()
    except (TypeError, AttributeError, ValueError) as e:
        return [Finding(
            rule="kernel-budget", severity="error", path="cocoa_torch/ops",
            line=1, col=0,
            message=(f"the budget sweep could not run ({type(e).__name__}: "
                     f"{e}) — the plans' API drifted out from under the "
                     f"analyzer; update analysis/kernel_budget.py"))]


# --- the card half ----------------------------------------------------------


def _declare(lib) -> None:
    lib.kernel_count.restype = ctypes.c_int
    lib.kernel_count.argtypes = []
    lib.kernel_name.restype = ctypes.c_char_p
    lib.kernel_name.argtypes = [ctypes.c_int]
    lib.kernel_info.restype = ctypes.c_int
    lib.kernel_info.argtypes = [ctypes.c_int, ctypes.c_int,
                                ctypes.c_longlong,
                                ctypes.POINTER(ctypes.c_longlong)]


def card_report(device="cuda", cases=None) -> tuple:
    """(rows, failures): each case of :func:`main_path_cases` (at the
    card's opt-in and SMs) with its kernel's registers, static shared
    memory, spill bytes, most threads a block and blocks an SM at the
    plan's dynamic bytes; a failure where the library has no such kernel,
    the query fails, static + dynamic exceeds ``kernels.smem_optin``, the
    block is wider than the kernel takes, or not one block fits an SM."""
    import torch

    from cocoa_torch import kernels

    dev = torch.device(device)
    optin = kernels.smem_optin(dev)
    if cases is None:
        cases = main_path_cases(optin, kernels.sm_count(dev))
    libs, index = {}, {}
    rows, failures = [], []
    for c in cases:
        if c.lib not in libs:
            # torchlint: allow=kernel-budget -- reads the kernels' attribute
            # tables through kernel_info; launches no kernel
            lib = kernels.load(c.lib)
            _declare(lib)
            libs[c.lib] = lib
            index[c.lib] = {lib.kernel_name(i).decode(): i
                            for i in range(lib.kernel_count())}
        lib = libs[c.lib]
        i = index[c.lib].get(c.kernel)
        if i is None:
            failures.append(f"{c.tag} {c.label}: {c.lib} has no kernel "
                            f"{c.kernel}")
            continue
        out = (ctypes.c_longlong * 6)()
        with torch.cuda.device(dev):
            rc = lib.kernel_info(i, c.threads, c.dyn, out)
        if rc != 0:
            failures.append(f"{c.tag} {c.label}: kernel_info({c.kernel}, "
                            f"{c.threads} threads, {c.dyn} B) failed: "
                            f"{lib.cuda_error_string(rc).decode()}")
            continue
        regs, static, spill, max_threads, blocks, max_dyn = list(out)
        row = dict(tag=c.tag, label=c.label, kernel=c.kernel,
                   threads=c.threads, dyn=c.dyn, plan=c.plan, regs=regs,
                   static=static, spill=spill, max_threads=max_threads,
                   blocks_per_sm=blocks, optin=optin)
        rows.append(row)
        if static + c.dyn > optin:
            failures.append(f"{c.tag} {c.label}: static {static} + dynamic "
                            f"{c.dyn} bytes over the opt-in {optin}")
        if c.threads > max_threads:
            failures.append(f"{c.tag} {c.label}: {c.threads} threads, the "
                            f"kernel takes {max_threads}")
        if blocks < 1:
            failures.append(f"{c.tag} {c.label}: no block of {c.threads} "
                            f"threads and {c.dyn} bytes fits an SM")
    return rows, failures
