"""A_log = log(A), A ~ U(``low``, ``high``) (Mamba-2's A_init_range)."""


def fill(rule, buf, gen):
    buf.uniform_(rule["low"], rule["high"], generator=gen).log_()
