"""pass_c_device_share (%): 100 x the regions whose pass C ran on the card
(the CLI's ``stats["pass_c_device"]``) over the regions
(``stats["regions"]``), summed over the window's jobs and legs.  A count:
how much of the host prepare's pass C took the device route.  A program
that does not count them reads None."""


def read(run):
    legs = [leg for j in run.ok_jobs for leg in j["legs"]]
    if not legs or any("pass_c_device" not in leg for leg in legs):
        return None
    regions = sum(leg["regions"] for leg in legs)
    if not regions:
        return None
    return 100.0 * sum(leg["pass_c_device"] for leg in legs) / regions
