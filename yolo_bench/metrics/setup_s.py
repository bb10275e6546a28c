"""Process start to the first timed call: imports, the program's kernel
libraries (built on a checkout's first run), weights, inputs, warm-up."""


def read(record):
    return record["setup_s"]
