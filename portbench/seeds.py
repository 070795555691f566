"""Seeds of the generators: one 63-bit seed for each part of a data set,
drawn from the run's ``--seed`` (any whole number, 2**31 and above too)."""
import numpy as np


def part_seed(seed: int, part: int) -> int:
    """The seed of part ``part`` of the data set of run seed ``seed``."""
    if seed < 0:
        raise ValueError(f"--seed must be a whole number >= 0, got {seed}")
    words = np.random.SeedSequence([int(seed) & (2**64 - 1), int(seed) >> 64, int(part)]).generate_state(2, np.uint32)
    return int(words[0]) << 31 | int(words[1]) >> 1
