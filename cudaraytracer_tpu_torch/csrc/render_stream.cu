// The megakernel's streamed layout: render_kernel.cu compiled with
// CRT_STREAMED, which keeps its streamed kernel entry and C function
// (crt_render_sample_streamed) and leaves out the resident ones.  A unit
// of its own, so that it compiles beside the resident instantiations and
// leaves their code as it was.
#define CRT_STREAMED 1
#include "render_kernel.cu"
