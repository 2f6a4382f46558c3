"""U(-``rule["bound"]``, ``rule["bound"]``)."""


def fill(rule, buf, gen):
    buf.uniform_(-rule["bound"], rule["bound"], generator=gen)
