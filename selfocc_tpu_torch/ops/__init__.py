"""ops — see the matching subpackage of selfocc_tpu."""
