"""The SASS instruction counts behind K3's and K3b's bounds in
``chip_smoke.py``, on a listing in ``cuobjdump -sass``'s format.

The smoke disassembles the built kernel library on the card; here a small
listing pins what it counts: the straight path to the first EXIT, without
the division slow path's call sites that a predicated branch jumps over,
by pipe, per value after the baseline probe, and the bound's three terms.
"""
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

LISTING = """
	code for sm_90a
		Function : sass_probe_copy4
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                          /* 0x00000a00ff017b82 */
                                                                                   /* 0x000fe40000000800 */
        /*0010*/                   S2R R5, SR_TID.X ;                              /* 0x0000000000057919 */
        /*0020*/                   LDG.E.128 R8, desc[UR4][R2.64] ;                /* 0x0000000402087981 */
        /*0030*/                   STG.E.128 desc[UR4][R4.64], R8 ;                /* 0x0000000804007986 */
        /*0040*/                   EXIT ;                                          /* 0x000000000000794d */
        /*0050*/                   BRA 0x50;                                       /* 0xfffffffc00fc7947 */
		Function : sass_probe_tanh
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                          /* 0x00000a00ff017b82 */
        /*0010*/                   S2R R5, SR_TID.X ;                              /* 0x0000000000057919 */
        /*0020*/                   LDG.E.128 R8, desc[UR4][R2.64] ;                /* 0x0000000402087981 */
        /*0030*/                   FFMA.RM R0, R8, 0.5, R7 ;                       /* 0x0000000402037981 */
        /*0040*/                   LOP3.LUT R0, R0, 0x80000000, R6, 0xf8, !PT ;    /* 0x0000000402037981 */
        /*0050*/                   FCHK P0, R0, R3 ;                               /* 0x0000000402037981 */
        /*0060*/                   BSSY B0, 0xa0 ;                                 /* 0x0000000402037981 */
        /*0070*/                   @!P0 BRA 0xa0 ;                                 /* 0x0000000402037981 */
        /*0080*/                   MOV R4, 0xa0 ;                                  /* 0x0000000402037981 */
        /*0090*/                   CALL.REL.NOINC 0xf0 ;                           /* 0x0000000402037981 */
        /*00a0*/                   BSYNC B0 ;                                      /* 0x0000000402037981 */
        /*00b0*/                   @P1 BRA 0xd0 ;                                  /* 0x0000000402037981 */
        /*00c0*/                   IMAD.MOV.U32 R9, RZ, RZ, R0 ;                   /* 0x0000000402037981 */
        /*00d0*/                   STG.E.128 desc[UR4][R4.64], R8 ;                /* 0x0000000804007986 */
        /*00e0*/                   EXIT ;                                          /* 0x000000000000794d */
        /*00f0*/                   FFMA R0, R3, 0.5, R7 ;                          /* 0x0000000402037981 */
        /*0100*/                   RET.REL.NODEC R4 0x0 ;                          /* 0x0000000402037981 */
        /*0110*/                   NOP;                                            /* 0x0000000402037981 */
"""


def test_common_path_skips_slow_path_call_and_stops_at_exit():
    funcs = chip_smoke.sass_functions(LISTING)
    assert set(funcs) == {"sass_probe_copy4", "sass_probe_tanh"}
    path = chip_smoke.sass_common_path(funcs["sass_probe_tanh"])
    ops = [chip_smoke.sass_opcode(v) for v in path]
    # MOV and CALL (the slow path's call site) are jumped over; the
    # subroutine after EXIT and the NOP padding are not reached
    assert ops == ["LDC", "S2R", "LDG", "FFMA", "LOP3", "FCHK", "BSSY", "BRA", "BSYNC",
                   "BRA", "IMAD", "STG", "EXIT"]
    assert chip_smoke.sass_mix_of(path) == {"int32": 2, "fp32": 2, "other": 9, "total": 13}


def test_per_value_counts_and_bound_terms():
    per = chip_smoke.sass_per_value(
        LISTING, {"tanh": ("sass_probe_tanh", 4, "sass_probe_copy4")})["tanh"]
    assert per == {"int32": 0.5, "fp32": 0.5, "other": 1.0, "total": 2.0}
    with pytest.raises(chip_smoke.SmokeFailure, match="not found"):
        chip_smoke.sass_per_value(LISTING, {"exp": ("sass_probe_exp", 4, "sass_probe_copy4")})
    n, sms, clock = 4096 * 128, 132, 1.98e9
    ms, term, terms = chip_smoke.sass_bound_ms(
        n, 8 * n, {"int32": 20, "total": 200}, sms, clock)
    assert terms["bytes"] == pytest.approx(8 * n / 3.35e12 * 1e3)
    assert terms["int32"] == pytest.approx(n * 20 / (64 * sms * clock) * 1e3)
    assert terms["issue"] == pytest.approx(n * 200 / (128 * sms * clock) * 1e3)
    assert (ms, term) == (terms["issue"], "issue")
    assert chip_smoke.contract_bound_by(term) == "operations"
    assert chip_smoke.contract_bound_by("bytes") == "bytes"


W8A8_LISTING = """
	code for sm_90a
		Function : _ZN48_GLOBAL__N__a062d797_15_conv1d_fused_cu_c691eb6217conv1d_mma_kernelILi32ELi64ELb1EEEvNS_9ConvShapeEN4imma8EpilogueE
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                          /* 0x00000a00ff017b82 */
        /*0010*/              @!P0 LDGSTS.E.BYPASS.LTC128B.128 [R3], desc[UR4][R4.64] ; /* 0x0000000004037fae */
        /*0020*/                   LDGDEPBAR ;                                     /* 0x00000000000079af */
        /*0030*/                   IMMA.16832.S8.S8 R8, R12.ROW, R16.COL, R8 ;     /* 0x000000100c087237 */
        /*0040*/                   IMMA.16832.S8.S8 R20, R12.ROW, R18.COL, R20 ;   /* 0x000000120c147237 */
        /*0050*/                   STG.E.64 desc[UR4][R6.64], R8 ;                 /* 0x0000000806007986 */
        /*0060*/                   EXIT ;                                          /* 0x000000000000794d */
		Function : _ZN48_GLOBAL__N__d296ab94_15_quant_matmul_cu_b465976110qmm_kernelILi8ELb1EEEvNS_8QmmShapeEN4imma8EpilogueE
	.headerflags	@"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDG.E.128.CONSTANT R4, desc[UR4][R2.64] ;       /* 0x0000000402047981 */
        /*0010*/                   LDG.E.128.CONSTANT R8, desc[UR4][R2.64+0x40] ;  /* 0x0000400402087981 */
        /*0020*/                   LDG.E.U8 R12, desc[UR4][R2.64] ;                /* 0x00000004020c7981 */
        /*0030*/                   IMMA.16832.S8.S8 R8, R12.ROW, R16.COL, R8 ;     /* 0x000000100c087237 */
        /*0040*/               @P1 RED.E.ADD.STRONG.GPU desc[UR4][R6.64], R8 ;     /* 0x000000080600798e */
        /*0050*/                   ATOMG.E.EXCH.STRONG.GPU PT, R9, desc[UR4][R6.64], RZ ; /* 0x000000ff0609798e */
        /*0060*/                   REDUX.SUM R10, R11 ;                            /* 0x000000000b0a73c4 */
        /*0068*/               @P2 REDG.E.ADD.STRONG.GPU desc[UR4][R6.64], R9 ;    /* 0x000000090600798e */
        /*0070*/                   EXIT ;                                          /* 0x000000000000794d */
		Function : sass_probe_copy
        /*0000*/                   IMMA.16832.S8.S8 R8, R12.ROW, R16.COL, R8 ;     /* 0x000000100c087237 */
"""


def test_w8a8_mix_counts_tensor_core_load_and_atomic_instructions():
    """K1's and K2's template instances by name and arguments; IMMA, cp.async
    (LDGSTS), 16-byte loads, ATOMG and RED/REDG counted (not byte loads,
    not the REDUX warp reduction), other functions left out."""
    mix = chip_smoke.sass_w8a8_mix(W8A8_LISTING)
    assert mix == {
        "conv1d_mma_kernel<32,64,1>": {"IMMA": 2, "LDGSTS": 1, "LDG.E.128": 0, "ATOMG": 0, "RED": 0},
        "qmm_kernel<8,1>": {"IMMA": 1, "LDGSTS": 0, "LDG.E.128": 2, "ATOMG": 1, "RED": 2},
    }
    assert chip_smoke.sass_mnemonic("@!P0 LDG.E.128 R4, desc[UR4][R2.64]") == "LDG.E.128"
