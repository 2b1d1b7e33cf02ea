"""setup_s: seconds from the process's start to the first timed frame:
imports, the CUDA context, the kernel library (built on a checkout's first
run, loaded from its build directory after), the scene, its packing and
the traffic's warm-up frames.  Host clock."""


def read(rec):
    return rec["setup_s"]
