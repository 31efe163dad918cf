// The instances of mha.cu at head width 256, in a translation unit of
// their own so that they compile in parallel with the others (mha.cu's
// closing note).
#define BFT_MHA_WIDTH 256
#include "mha.cu"
