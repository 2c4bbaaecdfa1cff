"""The plain reference the benchmark judges the codec against: NumPy only.

It imports nothing of the measured package and takes nothing it made: the
tables, the canonical codes, the container layout and the float64
transforms are worked out here again from the codec's published
definition (JPEG tables of ITU-T T.81 Annex K, IJG quality scaling, the
TPDC container layout).
"""
