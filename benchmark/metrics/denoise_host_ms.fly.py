"""denoise_host_ms.fly: host ms of the a-trous denoiser inside the program
(its ``crt.denoise`` span: ``atrous_denoise`` queuing its operations, 25
shifted views an iteration), mean over the window's frames."""

from benchmark import program_spans


def read(rec):
    return program_spans.mean_ms(rec, "crt.denoise")
