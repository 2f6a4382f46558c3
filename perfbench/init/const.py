"""Every value ``rule["value"]`` (norm scales, D)."""


def fill(rule, buf, gen):
    buf.fill_(rule["value"])
