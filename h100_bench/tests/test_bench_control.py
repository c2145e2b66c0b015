"""The control: the reference in the program's place at the precision
below the configuration's (fp8 weights and inputs) fails the cell's limit,
where the program passes it. At the cells' size this runs on the card
(``calibrate.py --control 1``); here at toy size on the CPU."""

from h100_bench import run


def test_the_fp8_control_fails_where_the_program_passes(spec):
    state = run.serve(spec, "tiny-moe.tinychat", 31337, 1.5, False, device="cpu")
    res = run.result(state)
    ch = res["checks"]
    control = run.gap_numbers(run.gaps(state.params, state.arch, state.win, state.sample,
                                       "cpu", quant="fp8"))
    assert res["correct"]
    assert control["max_logit_gap"] > ch["max_logit_gap"]["limit"] >= ch["max_logit_gap"]["value"]
