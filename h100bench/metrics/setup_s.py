"""setup_s: seconds from the process's start to the window's: tables made,
store, catalog and prepared queries, upload, warm-up (and, in a fresh
checkout, the kernel library's build)."""


def read(run):
    return run.setup_s
