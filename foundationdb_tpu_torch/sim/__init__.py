"""The port's simulation pieces: the brute-force conflict oracle
(``oracle.py``) that every engine is held to."""
