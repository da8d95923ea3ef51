"""4-bit weight representation: bit-planes, ECL assignment, QAT state."""
