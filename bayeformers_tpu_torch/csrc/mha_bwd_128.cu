// The instances of mha_bwd.cu at head width 128, in a translation unit of
// their own so that they compile in parallel with the others (mha_bwd.cu's
// closing note).
#define BFT_MHA_WIDTH 128
#include "mha_bwd.cu"
