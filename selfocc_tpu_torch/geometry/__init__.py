"""geometry — see the matching subpackage of selfocc_tpu."""
