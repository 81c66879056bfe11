"""SILK resampler coefficients (RFC 6716 section 4.2 normative
constants): the three tables of mousiki_tpu/silk/tables.py that the
device up-resampler is built from."""

# flake8: noqa

SILK_RESAMPLER_UP2_HQ_0 = [1746, 14986, -26453]
SILK_RESAMPLER_UP2_HQ_1 = [6854, 25769, -9994]
SILK_RESAMPLER_FRAC_FIR_12 = [[189, -600, 617, 30567], [117, -159, -1070, 29704], [52, 221, -2392, 28276], [-4, 529, -3350, 26341], [-48, 758, -3956, 23973], [-80, 905, -4235, 21254], [-99, 972, -4222, 18278], [-107, 967, -3957, 15143], [-103, 896, -3487, 11950], [-91, 773, -2865, 8798], [-71, 611, -2143, 5784], [-46, 425, -1375, 2996]]
