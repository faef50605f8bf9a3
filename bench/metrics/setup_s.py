"""Process start to window open: imports, the card, the kernel libraries
(built on a checkout's first run), weights, warm-up and the lane fill."""


def read(record):
    return record["setup_s"]
