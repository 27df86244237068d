"""The kinds of call a traffic mix can drive, one module each, named by
the mix's `caller`.  A module's `Caller(cfg, traffic, seed, device, log)`
runs the cell's set-up and warm-up, then offers:

    prepare(i) -> payload        the i-th call's inputs, from the seed
    call(payload) -> out         one call into the program under test
    ok(out), units(payload)      a finite answer; the work it counts
    keep(i, payload, out, ok)    what the check will need
    release()                    frees the program's state
    sample() -> [(payload, out)] the checked calls, drawn from the seed
    reference(payload, dtype)    the plain reference's answer
    compare(outs, refs) -> {number: value}
    control(payloads) -> [out]   the control put in the program's place
"""
