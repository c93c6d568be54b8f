"""next_batch_host_reads: the mean count a round of synchronizing
device-to-host operations inside Sober.next_batch, from torch.cuda's sync
debug mode (the traced run's reads phase, which adds no other sync)."""


def read(r):
    return sum(r.reads) / len(r.reads) if r.reads else None
