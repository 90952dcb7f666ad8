"""The traced calls of the family's grouped expert op (the dropless
experts, `repro_torch.models.moe.grouped_experts`: the pairs' rows
gathered, three grouped products, the combine): least time (max of 2
flops a weight a pair over 989 TFLOP/s and the bytes of k experts'
weights and the token rows over 3.35 TB/s, the family's `experts_work`)
over their device time, in %.  None where the program has no such op."""


def read(run):
    return None if run.trace is None else \
        run.trace.roofline("grouped_experts")
