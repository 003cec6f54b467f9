"""Set-up seconds: from the process's start to the first timed step
(imports, weights and inputs from the seed, the program's builds, the
set-up steps that warm every shape)."""


def read(run):
    return run.setup_s
