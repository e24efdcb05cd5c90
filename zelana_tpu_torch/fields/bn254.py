"""BN254 (alt_bn128) curve constants.

The parameter set matches arkworks `ark-bn254 =0.5.0` (the reference prover's
pinned curve backend; see the reference's prover/Cargo.toml:28) and Solana's
`alt_bn128` syscalls (onchain-programs/verifier .../lib.rs:4).

All values are plain Python ints; this module is the single source of truth
for moduli and curve parameters across the golden (host) implementation and
the device limb kernels (ops/limbs.py, csrc/field.cuh).
"""

# Base field modulus (Fq)
P = 21888242871839275222246405745257275088696311157297823662689037894645226208583

# Scalar field modulus (Fr) -- the R1CS field
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617

# BN parameter x such that p(x), r(x) are the BN polynomials
BN_X = 4965661367192848881

# Curve: y^2 = x^3 + 3 over Fq
B_G1 = 3

# G1 generator
G1_GEN = (1, 2)

# Fq2 = Fq[u] / (u^2 + 1)
# G2: y^2 = x^3 + b2 with b2 = 3 / (9 + u)
# b2 = (19485874751759354771024239261021720505790618469301721065564631296452457478373,
#       266929791119991161246907387137283842545076965332900288569378510910307636690)
B_G2_C0 = 19485874751759354771024239261021720505790618469301721065564631296452457478373
B_G2_C1 = 266929791119991161246907387137283842545076965332900288569378510910307636690

# G2 generator (affine, (x.c0, x.c1), (y.c0, y.c1))
G2_GEN_X = (
    10857046999023057135944570762232829481370756359578518086990519993285655852781,
    11559732032986387107991004021392285783925812861821192530917403151452391805634,
)
G2_GEN_Y = (
    8495653923123431417604973247489272438418190587263600148770280649306958101930,
    4082367875863433681332203403145435568316851327593401208105741076214120093531,
)

# Montgomery parameters used by arkworks (64-bit limbs, N=4 -> R = 2^256)
MONT_BITS = 256
MONT_R = 1 << 256

# Fr: number of bits
FR_BITS = 254
FQ_BITS = 254

# Two-adicity of Fr - 1 (r - 1 = 2^28 * t)
FR_TWO_ADICITY = 28
# Multiplicative generator of Fr (arkworks FrConfig::GENERATOR = 5)
FR_GENERATOR = 5
# 2^28-th primitive root of unity: 5^((r-1) >> 28) mod r
FR_TWO_ADIC_ROOT = pow(FR_GENERATOR, (R - 1) >> FR_TWO_ADICITY, R)

# Fq two-adicity (q - 1 = 2^1 * t)
FQ_TWO_ADICITY = 1
FQ_GENERATOR = 3

assert (R - 1) % (1 << FR_TWO_ADICITY) == 0
assert (R - 1) // (1 << FR_TWO_ADICITY) % 2 == 1
