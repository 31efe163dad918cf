// The instances of mha_bwd.cu at head width 256, in a translation unit of
// their own so that they compile in parallel with the others (mha_bwd.cu's
// closing note).
#define BFT_MHA_WIDTH 256
#include "mha_bwd.cu"
