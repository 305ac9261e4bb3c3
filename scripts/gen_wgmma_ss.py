"""Write ``medsam2_tpu_torch/csrc/wgmma_ss.cuh``: the bf16 ``wgmma`` products
D[64 x N] (+)= A[64 x 16] B[16 x N] with both operands K-major in shared
memory, one specialisation for each N that the encoder linear's column
tiles take (the multiples of 16 up to 192). Inline PTX names every
accumulator register, so each width is written out.

    python3 scripts/gen_wgmma_ss.py
"""

from pathlib import Path

OUT = Path(__file__).resolve().parents[1] / "medsam2_tpu_torch" / "csrc" / "wgmma_ss.cuh"


def one(n: int) -> str:
    regs = n // 2
    acc = ", ".join(f"%{i}" for i in range(regs))
    outs = ", ".join(f'"+f"(d[{i}])' for i in range(regs))
    return f'''template <>
struct WgmmaSS<{n}> {{
  __device__ __forceinline__ static void mma(float* d, uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {{
    asm volatile(
        "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{regs + 2}, 0;\\n"
        "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "
        "{{{acc}}}, %{regs}, %{regs + 1}, p, 1, 1, 0, 0;\\n}}\\n"
        : {outs}
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }}
}};
'''


def main() -> None:
    parts = ['''// Generated by scripts/gen_wgmma_ss.py; do not edit by hand.
//
// bf16 wgmma products for the encoder linear (encoder_linear_sm90.cuh):
// WgmmaSS<N>::mma(d, desc_a, desc_b, scale_d) issues
// D[64 x N] (+)= A[64 x 16] * B[16 x N] with A and B K-major in shared
// memory (descriptors as hopper::make_desc builds them); scale_d 0
// overwrites D. d holds the N / 2 fp32 accumulators of this thread in the
// wgmma fragment order: d[4 j + e] is row (warp % 4) * 16 + lane / 4 + 8 (e / 2),
// column 8 j + 2 (lane % 4) + (e % 2).
#pragma once

#include <stdint.h>

namespace medsam2 {
namespace hopper {

template <int N>
struct WgmmaSS;

''']
    parts += [one(n) for n in range(16, 193, 16)]
    parts.append("}  // namespace hopper\n}  // namespace medsam2\n")
    OUT.write_text("\n".join(parts))


if __name__ == "__main__":
    main()
