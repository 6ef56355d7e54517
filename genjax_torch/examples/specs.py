"""Per program: which of its JAX program's result lines the port is held
to, and how (:mod:`genjax_torch.examples.holding`). A value the JAX
program prints to d decimals gets an absolute bound of 0.6·10^-d; lines
that print times, reprs, device or rank counts, or traced-equation
counts are named in ``not_compared`` with the reason."""

from genjax_torch.examples.holding import (
    Check,
    Program,
    absolute,
    contains,
    exact,
    mc,
    printed,
    text,
)

__all__ = ["PROGRAMS"]

BETA = ("the beta sampler's rejection loop draws other variates from the "
        "same keys (ROADMAP §3)")
CDF = ("resampling: the CDF kernel's plain version sums in another order "
       "than JAX's (ROADMAP §3), so resampled ensembles differ")
ADEV = "the ADEV tail-call key deviation (ROADMAP §3)"
NUTS = ("NUTS warmup: the adapted step size amplifies an ulp of the "
        "gradient, so chains differ after warmup")
SMC2 = ("SMC²'s inner rows resample by f32 cumulative counts summed in "
        "another order than JAX's (ROADMAP §3)")
ESS_ROUNDED = absolute(0.51, "the JAX program prints the ESS to the unit")

PROGRAMS = {p.name: p for p in (
    Program("ex01_beta_bernoulli_sir", "examples/01_beta_bernoulli_sir.py", (
        Check("E[p | v=True]", 0, "mean_true", mc(4, "mean_true", BETA)),
        Check("E[p | v=False]", 0, "mean_false",
              mc(4, "mean_false", BETA)),
    ), {"(exact: ...)": "the closed forms, constants of the program"}),
    Program("ex02_state_space_pf", "examples/02_state_space_pf.py", (
        Check("logZ estimate:", 0, "log_z", mc(4, "log_z", CDF)),
        Check("final ensemble ESS:", 0, "ess", mc(4, "ess", CDF)),
    )),
    Program("ex03_nuts_regression", "examples/03_nuts_regression.py", (
        Check("slope mean:", 0, "slope_mean", mc(4, "slope_mean", NUTS)),
        Check("slope R-hat:", 0, "slope_rhat", mc(4, "slope_rhat", NUTS)),
        Check("mean accept:", 0, "mean_accept",
              mc(4, "mean_accept", NUTS)),
    )),
    Program("ex04_variational_inference",
            "examples/04_variational_inference.py", (
                Check("learned v:", 0, "learned_v", exact()),
            )),
    Program("ex05_sharded_smc", "examples/05_sharded_smc.py", (
        Check("logZ:", 0, "log_z", mc(4, "log_z", BETA)),
    ), {"mesh:": "a repr of the JAX mesh or the torch DeviceMesh",
        "weights sharded over:": "devices or ranks in the world"}),
    Program("ex06_time_travel_debugging",
            "examples/06_time_travel_debugging.py", (
                Check("frame 'doubled':", 0, "frame_doubled", exact()),
                Check("final:", 0, "final", exact()),
                Check("counterfactual:", 0, "counterfactual", exact()),
                Check("remix(5.0) final:", 0, "remix_final", exact()),
            ), {"<TimeTravelingDebugger ...>": "a repr; the same frames"}),
    Program("ex07_tempered_smc", "examples/07_tempered_smc.py", (
        Check("logZ:", 0, "log_z", exact()),
        Check("posterior mean:", 0, "posterior_mean", exact()),
        Check("rejuvenation accept rates:", slice(0, 20), "accept_rates",
              exact()),
    )),
    Program("ex08_trace_level_pf", "examples/08_trace_level_pf.py", (
        Check("logZ:", 0, "log_z", exact()),
        Check("logZ:", 1, "exact", exact()),
        Check("ESS history:", slice(0, 10), "ess_history", ESS_ROUNDED),
    )),
    Program("ex09_smc_samplers", "examples/09_smc_samplers.py", (
        Check("waste-free logZ:", 0, "waste_free_log_z", exact()),
        Check("waste-free logZ:", 2, "ensemble", exact()),
        Check("data-SMC posterior mean p:", 0, "data_smc_mean_p",
              mc(4, "data_smc_mean_p", BETA)),
        Check("data-SMC posterior mean p:", slice(2, 7), "ess_history",
              mc(4, "ess_history", BETA, floor=0.51)),
    )),
    Program("ex10_state_space_vi", "examples/10_state_space_vi.py", (
        Check("trained guide mean:", 0, "trained_mean",
              mc(4, "trained_mean", ADEV)),
    )),
    Program("ex11_constrained_nuts", "examples/11_constrained_nuts.py", (
        Check("inferred transforms:", 0, "transforms", text()),
        Check("posterior mean:", slice(0, 3), "posterior_mean",
              mc(4, "posterior_mean", NUTS)),
        Check("exact (conjugate):", slice(0, 3), "exact", exact()),
        Check("scan scales min:", 0, "scan_scales_min",
              mc(4, "scan_scales_min", NUTS)),
    )),
    Program("ex12_particle_gibbs", "examples/12_particle_gibbs.py", (
        Check("PGAS max |mean - RTS|:", 0, "pgas_err", exact(1e-4)),
        Check("trace-PG max |mean - RTS|:", 0, "trace_pg_err", exact(1e-4)),
    )),
    Program("ex13_parameter_inference",
            "examples/13_parameter_inference.py", (
                Check("exact posterior over a:", 0, "exact_mean", printed(3)),
                Check("exact posterior over a:", 1, "exact_std", printed(3)),
                Check("exact posterior over a:", 2, "exact_log_ev",
                      printed(2)),
                Check("PMMH:", 0, "pmmh_mean", mc(4, "pmmh_mean", CDF)),
                Check("PMMH:", 1, "pmmh_std", mc(4, "pmmh_std", CDF)),
                Check("PMMH:", 2, "pmmh_accept", mc(4, "pmmh_accept", CDF)),
                Check("SMC2:", 0, "smc2_mean", mc(4, "smc2_mean", SMC2)),
                Check("SMC2:", 1, "smc2_log_z", mc(4, "smc2_log_z", SMC2)),
                Check("SMC2:", 2, "smc2_accept",
                      mc(4, "smc2_accept", SMC2)),
            )),
    Program("ex14_pod_scale_inference",
            "examples/14_pod_scale_inference.py", (
                Check("sharded PF logZ:", 0, "pf_log_z",
                      mc(4, "pf_log_z", CDF)),
                Check("sharded NUTS: mu posterior mean", 0, "nuts_mu_mean",
                      printed(3)),
            ), {"... on N devices / chains over N devices": "devices or "
                "ranks in the world",
                "bitwise equal on a 1-device mesh:": "True in both: the "
                "port's own assertion",
                "elastic down-shift:": "device or rank counts; the port "
                "asserts its values unchanged"}),
    Program("ex15_svgd_and_slice", "examples/15_svgd_and_slice.py", (
        Check("SVGD  mean err:", 0, "svgd_err",
              mc(4, "svgd_err", "SVGD: the AdaGrad path amplifies the f32 "
                 "rounding of the kernel sums, which run in another order")),
        Check("ESS   mean err:", 0, "ess_err", exact(1e-4)),
        Check("NUTS  mean err:", 0, "nuts_err", exact(1e-4)),
    )),
    Program("cb01_the_gfi", "cookbook/01_the_gfi.py", (
        Check("simulate:", 0, "x", exact()),
        Check("simulate:", 1, "y", exact()),
        Check("assess:", 2, "assess", exact()),
        Check("generate:", 0, "generate", exact()),
        Check("update:", 0, "update", exact()),
        Check("regenerate:", 0, "regenerate_x", exact()),
        Check("regenerate:", 1, "regenerate_w", exact()),
        Check("project:", 0, "project", exact()),
        Check("vmap'd IS:", 0, "is_log_z", exact()),
        Check("vmap'd IS:", 1, "is_exact", exact()),
    )),
    Program("cb02_choice_maps", "cookbook/02_choice_maps.py", (
        Check("posterior draw:", 0, "posterior_x", exact()),
        Check("posterior draw:", 1, "weight", exact()),
    ), {"pformat dumps": "reprs of choice maps"}),
    Program("cb03_debugging", "cookbook/03_debugging.py", (
        Check("AddressReuse caught:", 0, "address_reuse", text()),
        Check("MissingAddress caught:", 0, "missing_address", text()),
        Check("silent unmask (checks off):", 0, "silent_unmask", exact()),
        Check("checkify says:", 0, "checkify",
              contains("jax.checkify appends where the check failed")),
        Check("score  =", 0, "score", exact()),
        Check("retval =", 0, "retval", exact()),
        Check("frames:", 0, "final", exact()),
        Check("at 'doubled':", 0, "at_doubled", exact()),
        Check("counterfactual final:", 0, "counterfactual", exact()),
    ), {"the rest of the StaticTrace dump": "a repr"}),
    Program("cb04_speed_gains", "cookbook/04_speed_gains.py", (
        Check("edit weight == Δscore:", 0, "edit_weight", exact()),
        Check("one jitted sweep, total log-ratio:", 0, "sweep_total",
              exact()),
    ), {"traced equations:": "jaxpr equation counts; the port counts the "
        "sites each edit path re-scores instead"}),
    Program("cb05_conditionals_and_masking",
            "cookbook/05_conditionals_and_masking.py", (
                Check("live branch score:", 0, "live_score", exact()),
                Check("effect:", 0, "effect", exact()),
                Check("P(alt | effect=2.9) ≈", 0, "p_alt", exact()),
                Check("or_else retvals:", slice(0, 2), "or_else", exact()),
                Check("masked scores:", slice(0, 2), "masked_scores",
                      exact()),
                Check("3 live steps from 0.0 →", 0, "live_steps_final",
                      exact()),
            )),
    Program("cb06_custom_distributions",
            "cookbook/06_custom_distributions.py", (
                Check("∫ pdf =", 0, "mass", exact()),
                Check("prior draw p =", 0, "prior_p", exact()),
                Check("E[p | 17/20 heads] ≈", 0, "post_mean", exact()),
            )),
    Program("cb07_custom_proposals", "cookbook/07_custom_proposals.py", (
        Check("prior  logZ ≈", 0, "prior_log_z", printed(4)),
        Check("prior  logZ ≈", 1, "exact_log_z", printed(4)),
        Check("prior  logZ ≈", 2, "prior_var", printed(3)),
        Check("smart  logZ ≈", 0, "smart_log_z", printed(4)),
        Check("smart  logZ ≈", 2, "smart_var", printed(3)),
        Check("ESS fraction:", 0, "prior_ess_frac", printed(2)),
        Check("ESS fraction:", 1, "smart_ess_frac", printed(2)),
    )),
    Program("cb08_marginals_and_stochastic_probabilities",
            "cookbook/08_marginals_and_stochastic_probabilities.py", (
                Check("log p(value=1):", 0, "estimated", printed(4)),
                Check("log p(value=1):", 1, "closed_form", printed(4)),
                Check("single-draw estimator std", 0, "std_single",
                      printed(3)),
                Check("single-draw estimator std", 2, "std_k16", printed(3)),
                Check("outer draw:", 0, "outer_draw", exact()),
                Check("outer draw:", 1, "outer_score", exact()),
                Check("logZ through the outer model:", 0, "outer_log_z",
                      exact()),
            )),
    Program("cb09_h100_performance", "cookbook/09_tpu_performance.py", (
        Check("cookbook 9 ok:", 0, "posterior_mean",
              mc(4, "posterior_mean", BETA)),
        Check("cookbook 9 ok:", 1, "cdf_tail", exact()),
        Check("cookbook 9 ok:", 2, "n2", exact()),
    ), {"the other lines of the port": "checks the JAX page makes with "
        "asserts (gather vs repeat, the CDF tail and monotonicity) and the "
        "op count of a key derivation, which depends on the device"}),
    Program("cb10_ravi_stacks", "cookbook/10_ravi_stacks.py", (
        Check("cookbook 10 ok:", 0, "exact", printed(3)),
        Check("cookbook 10 ok:", 1, "var_prior", printed(3)),
        Check("cookbook 10 ok:", 2, "var_ravi", printed(3)),
    )),
    Program("cb11_dirichlet_mixture_gibbs",
            "cookbook/11_dirichlet_mixture_gibbs.py", (
                Check("cookbook 11 ok:", slice(0, 3), "mus", exact()),
                Check("cookbook 11 ok:", slice(3, 6), "weights",
                      mc(4, "weights", "the Dirichlet sampler's loggamma "
                         "rejection loop draws other variates from the "
                         "same keys (ROADMAP §3)")),
                Check("cookbook 11 ok:", 6, "acc", printed(3)),
            )),
    Program("cb12_combinators", "cookbook/12_combinators.py", (
        Check("lane 2 draw:", 0, "lane_2", exact()),
        Check("all lanes:", slice(0, 4), "all_lanes", exact()),
        Check("lane-1 constraint weight:", 0, "lane_1_weight", exact()),
        Check("3 iid draws:", slice(0, 3), "iid", exact()),
        Check("random-walk path:", slice(0, 5), "path", exact()),
        Check("iterate:", slice(0, 5), "iterate", exact()),
        Check("final:", 0, "final", exact()),
        Check("mixture draw:", 0, "mixture_draw", exact()),
        Check("picked component:", 0, "component", exact()),
        Check("non-centered draw:", 0, "non_centered", exact()),
        Check("contramapped:", 0, "contramapped", exact()),
        Check("fleet paths shape:", slice(0, 2), "fleet_shape", exact()),
        Check("lane 1, step 2:", 0, "fleet_1_2", exact()),
    )),
    Program("cb13_exact_oracles", "cookbook/13_exact_oracles.py", (
        Check("exact   P(burglary | both call) =", 0, "p_burglary",
              printed(4)),
        Check("exact   log P(both call)        =", 0, "log_marginal",
              printed(4)),
        Check("SIR     log-evidence estimate   =", 0, "sir_log_z",
              printed(4)),
        Check("MH      P(burglary | both call) =", 0, "mh_p_burglary",
              printed(4)),
    )),
    Program("cb14_smc2_joint_inference",
            "cookbook/14_smc2_joint_inference.py", (
                Check("posterior  E[a | y]  =", 0, "mean",
                      mc(4, "mean", SMC2)),
                Check("posterior  E[a | y]  =", 1, "exact_mean", printed(3)),
                Check("posterior sd[a | y]  =", 0, "std", mc(4, "std", SMC2)),
                Check("posterior sd[a | y]  =", 1, "exact_std", printed(3)),
                Check("evidence   log p(y)  =", 0, "log_z",
                      mc(4, "log_z", SMC2)),
                Check("evidence   log p(y)  =", 1, "exact_log_ev",
                      printed(2)),
                Check("PMMH acceptance over fired rejuvenations:", 0,
                      "rejuv_accept", mc(4, "rejuv_accept", SMC2)),
                Check("theta-ESS:", 0, "ess_start",
                      mc(4, "ess_start", SMC2, floor=0.51)),
                Check("theta-ESS:", 1, "ess_min",
                      mc(4, "ess_min", SMC2, floor=0.51)),
                Check("theta-ESS:", 2, "ess_final",
                      mc(4, "ess_final", SMC2, floor=0.51)),
            )),
)}
