"""N(0, ``rule["std"]``^2)."""


def fill(rule, buf, gen):
    buf.normal_(0.0, rule["std"], generator=gen)
