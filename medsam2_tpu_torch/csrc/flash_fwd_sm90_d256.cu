// bf16 flash forward (flash_fwd_sm90.cuh) for head dim D = 256, every value width.
#define MEDSAM2_FLASH_SM90_DEFINE
#include "flash_fwd_sm90.cuh"

MEDSAM2_FLASH_SM90_FOR_D(256)
