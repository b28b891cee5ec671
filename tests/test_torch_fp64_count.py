"""The FP64-pipe instruction count that bounds the geometric-consistency
kernel (s_volsdf_tpu_torch/tools/fp64_count.py), on a SASS listing in
cuobjdump's format: each FP64 opcode of the kernel's own body counts
once, predicated or not; the subroutines it calls and other functions
count apart or not at all. (The listing of the real kernel comes from a
build on the card: chip_smoke.py phase 7.)"""

from s_volsdf_tpu_torch.tools.fp64_count import count_sass, is_fp64

SASS = """
\tcode for sm_90a
\t\tFunction : _Z5otherPd
        /*0000*/                   DADD R2, R2, R4 ;                 /* 0x000000040202722b */
\t\tFunction : _ZN12_GLOBAL__N_122geo_consistency_kernelEPKfS1_ii7GeoMatsddPhPdS4_S4_
        /*0000*/                   LDC R1, c[0x0][0x28] ;            /* 0x00000a00ff017b82 */
        /*0010*/                   F2F.F64.F32 R4, R3 ;              /* 0x0000000300047310 */
        /*0020*/                   I2F.F64 R6, R0 ;                  /* 0x0000000000067312 */
        /*0030*/                   DMUL R8, R4, R6 ;                 /* 0x0000000604087228 */
        /*0040*/                   DFMA R8, R8, R6, R4 ;             /* 0x000000060808722b */
        /*0050*/              @!P0 DADD R10, R8, -R4 ;               /* 0x800000040808a229 */
        /*0060*/                   MUFU.RCP64H R13, R9 ;             /* 0x0000000900137308 */
        /*0070*/                   FRND.F64.FLOOR R14, R8 ;          /* 0x0000000800147313 */
        /*0080*/                   DSETP.GEU.AND P0, PT, R8, R4, PT ; /* 0x000000040800722a */
        /*0090*/                   FADD R3, R3, R5 ;                 /* 0x0000000503037221 */
        /*00a0*/                   F2I.F64.TRUNC R2, R8 ;            /* 0x0000000800027311 */
        /*00b0*/                   MUFU.RSQ64H R15, R9 ;             /* 0x00000009000f7308 */
        /*00c0*/                   CALL.REL.NOINC `($__internal_0_$__cuda_sm20_div_rn_f64_full) ;
        /*00d0*/                   EXIT ;
.L_x_1:
        /*00e0*/                   BRA `(.L_x_1);
$__internal_0_$__cuda_sm20_div_rn_f64_full:
        /*00f0*/                   DFMA R4, R2, R6, R4 ;             /* 0x000000060204722b */
        /*0100*/                   DMUL R4, R4, R6 ;                 /* 0x000000060404722b */
        /*0110*/                   RET.REL.NODEC R2 `(_ZN12geo) ;
"""


def test_count_sass_main_body_and_subroutines():
    got = count_sass(SASS, "geo_consistency_kernel")
    assert got["by_opcode"] == {
        "DADD": 1, "DFMA": 1, "DMUL": 1, "DSETP.GEU.AND": 1,
        "F2F.F64.F32": 1, "F2I.F64.TRUNC": 1, "FRND.F64.FLOOR": 1,
        "I2F.F64": 1, "MUFU.RCP64H": 1, "MUFU.RSQ64H": 1}
    assert got["main"] == 10 and got["subroutines"] == 2


def test_fp64_opcodes():
    for op in ("DFMA", "DSETP.GT.AND", "DMNMX", "F2F.F32.F64", "I2F.F64.S64",
               "FRND.F64.CEIL", "MUFU.RCP64H"):
        assert is_fp64(op), op
    for op in ("FFMA", "F2F.F16.F32", "I2F.S32", "MUFU.RCP", "FRND.FLOOR",
               "DEPBAR"):
        assert not is_fp64(op), op
